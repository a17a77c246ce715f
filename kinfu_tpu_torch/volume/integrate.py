"""TSDF fusion (integrate): the dispatcher and the per-voxel gather path
(port of kinfu_tpu/volume/integrate.py).

`integrate` routes a frame to the face-warp fusion (K2 + K3,
`ops/face_integrate.py::integrate_warped`) or to the gather path below,
which projects every voxel into the depth map and folds the truncated SDF
observation into the running weighted average, one Z-chunk at a time (the
counterpart of the JAX package's `lax.scan`, L104-185). The JAX package
computes the gather path outside any Pallas kernel, so it stays plain
PyTorch on every device.

Math parity with device::integrate (tsdf_volume.cu:41-110):
  - voxel position = index * voxel_size (corner convention)
  - sdf = -(||vc|| / ||K^-1 [u,v,1]|| - depth), nearest-pixel lookup
  - update iff sdf >= -trunc: tsdf = min(1, sdf/trunc),
    w' = min(w+1, max_weight), t' = (t*w + tsdf)/(w + 1)
  - colour averaged only within |sdf| <= trunc/2
The volume is updated in place. A device flag `gate` (False: leave the
volume as it is) stands in for the JAX step's `lax.cond`, so no caller
branches on a device value.
"""

from __future__ import annotations

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import recip, rint_index, sqrt32
from kinfu_tpu_torch.volume.tsdf import (
    TSDFVolume,
    pack_rgb,
    tsdf_to_fixed,
    tsdf_to_float,
    unpack_rgb,
)


def _pick_z_chunk(z: int) -> int:
    """Largest power-of-two chunk <= 16 that divides Z."""
    for c in (16, 8, 4, 2, 1):
        if z % c == 0:
            return c
    return 1


def resolve_integrate_mode(params: KinFuParams, shape_zyx, device,
                           shard_dim: int | None = None) -> str:
    """"warped" or "gather": "auto" is "warped" on a CUDA device, "gather"
    elsewhere, and "warped" needs `warp_dims_ok` of the (local) shape in
    the `shard_dim` frame set (the JAX package's tiling rule; an untileable
    volume takes the gather path, as in JAX)."""
    from kinfu_tpu_torch.ops.facewarp import warp_dims_ok

    mode = params.integrate_mode
    if mode == "auto":
        mode = "warped" if torch.device(device).type == "cuda" else "gather"
    if mode == "warped" and not warp_dims_ok(tuple(shape_zyx), shard_dim):
        mode = "gather"
    return mode


def fold_shard_origin(vol2cam: Pose, z_offset: int, shard_dim: int,
                      voxel_size) -> Pose:
    """`vol2cam` of a slab whose first voxel along natural array dim
    `shard_dim` (0 = volume Z, 1 = volume Y) is global index `z_offset`:
    the translation moved by the slab origin, t + R[:, axis] * offset, so
    that the slab fuses as a volume of its own seen from that camera
    (kinfu_tpu/volume/integrate.py:80-96, parallel/sharded.py:436-444)."""
    if z_offset == 0:
        return vol2cam
    xyz_axis = 2 - shard_dim
    R, t = vol2cam
    off_m = float(np.float32(z_offset) * np.float32(voxel_size[xyz_axis]))
    return Pose(R, t + R[:, xyz_axis] * off_m)


def integrate(
    vol: TSDFVolume,
    depth_m: torch.Tensor,
    color_rgb: torch.Tensor,
    vol2cam: Pose,
    intr: Intrinsics,
    params: KinFuParams,
    z_offset: int = 0,
    shard_dim: int = 0,
    gate: torch.Tensor | None = None,
    faces: torch.Tensor | None = None,
) -> TSDFVolume:
    """Fuse one (depth [H,W] metres, colour [H,W,3] uint8) observation
    into `vol`, in place, and return it.

    `vol2cam` maps volume coordinates to the camera frame. `gate`, a device
    bool, leaves the volume unchanged where False: in warped mode it joins
    the face flags that K2 and K3 read, in gather mode the update mask.
    `vol` may be one rank's slab of a sharded volume (parallel/): its first
    voxel along natural array dim `shard_dim` (0 = volume Z, 1 = volume Y)
    is global index `z_offset` (a host int). The warped path folds the
    offset into the pose (`fold_shard_origin`), the gather path into the
    voxel positions, as the JAX dispatcher does. `faces`, bool [6] device
    face flags (the fused update's, pipeline/kinfu.py::update_volume),
    runs the warped path under them in place of the frustum's."""
    if faces is not None:
        mode = "warped"
    else:
        mode = resolve_integrate_mode(params, vol.tsdf.shape, vol.tsdf.device, shard_dim)
    if mode == "warped":
        from kinfu_tpu_torch.ops.face_integrate import integrate_warped

        return integrate_warped(
            vol, depth_m, color_rgb,
            fold_shard_origin(vol2cam, z_offset, shard_dim, params.voxel_size),
            intr, params, faces="auto" if faces is None else faces, gate=gate,
            shard_dim=shard_dim)
    integrate_gather(vol, depth_m, color_rgb, vol2cam, intr, params, gate, z_offset,
                     shard_dim)
    return vol


def integrate_gather(vol: TSDFVolume, depth_m: torch.Tensor, color_rgb: torch.Tensor,
                     vol2cam: Pose, intr: Intrinsics, params: KinFuParams,
                     gate: torch.Tensor | None = None, z_offset: int = 0,
                     shard_dim: int = 0) -> None:
    """The per-voxel gather pass, in place, in Z-chunks; a slab's global
    offset `z_offset` shifts its Z chunks (`shard_dim` 0) or its rows' y
    (1), in the JAX operation order (L117-126). Where the JAX
    package divides by a static value (the focal lengths, the truncation
    distance) this multiplies by its float32 reciprocal, and where it
    divides by a square root it multiplies by the root's reciprocal, as
    XLA's rsqrt rewrite does (1 / sqrt, rounded twice: XLA:CPU's rsqrt
    without AVX); `jnp.rint` is `torch.round`, and the uint8 cast of the
    mixed colour truncates."""
    Z, Y, X = vol.tsdf.shape
    h, w = depth_m.shape
    dev = vol.tsdf.device
    vsx, vsy, vsz = params.voxel_size
    trunc = params.trunc_dist
    inv_trunc = recip(trunc)
    max_weight = float(params.tsdf_max_weight)

    depth_flat = depth_m.reshape(-1)
    color_flat = pack_rgb(color_rgb).reshape(-1)
    R, t = vol2cam
    cz = _pick_z_chunk(Z)

    f32 = torch.float32
    iy = torch.arange(Y, dtype=f32, device=dev)[None, :, None]
    ix = torch.arange(X, dtype=f32, device=dev)[None, None, :]
    zz_local = (torch.arange(cz, dtype=f32, device=dev) * vsz)[:, None, None]
    # per-row terms of the camera-frame position, in the JAX operation order
    # ((R0 x + R1 y) + R2 z) + t. XLA reassociates R0 * (iota * vsx) into
    # (R0 * vsx) * iota, which rounds otherwise unless vsx is a power of
    # two; a Y slab's offset row coordinate, iota * vsy + offset, stays
    # R1 * y
    if shard_dim == 1:
        yy = iy * vsy + float(np.float32(z_offset) * np.float32(vsy))
        z_offset = 0
        rx = [(R[i, 0] * vsx) * ix + R[i, 1] * yy for i in range(3)]
    else:
        rx = [(R[i, 0] * vsx) * ix + (R[i, 1] * vsy) * iy for i in range(3)]

    for z0 in range(0, Z, cz):
        sl = slice(z0, z0 + cz)
        tsdf_c, weight_c, color_c = vol.tsdf[sl], vol.weight[sl], vol.color[sl]
        # float32(z0 + z_offset) * float32(vsz), as the JAX chunk offset rounds
        pz = zz_local + float(np.float32(z0 + z_offset) * np.float32(vsz))
        vcx, vcy, vcz = (rx[i] + R[i, 2] * pz + t[i] for i in range(3))

        in_front = vcz > 0
        zsafe = torch.where(in_front, vcz, 1.0)
        u = rint_index(vcx / zsafe * intr.fx + intr.cx)
        v = rint_index(vcy / zsafe * intr.fy + intr.cy)
        inb = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)

        lin = (v * w + u).clamp(0, h * w - 1)
        depth = depth_flat[lin]
        valid = inb & (depth > 0)

        lx = (u.float() - intr.cx) * recip(intr.fx)
        ly = (v.float() - intr.cy) * recip(intr.fy)
        vc_norm = sqrt32(vcx * vcx + vcy * vcy + vcz * vcz)
        # ||vc|| / lambda: XLA rewrites a / sqrt(b) into a * rsqrt(b)
        inv_lam = 1.0 / sqrt32(lx * lx + ly * ly + 1.0)
        sdf = -(vc_norm * inv_lam - depth)

        upd = valid & (sdf >= -trunc)
        if gate is not None:
            upd = upd & gate
        tsdf_obs = torch.clamp(sdf * inv_trunc, max=1.0)

        w_old = weight_c.float()
        t_old = tsdf_to_float(tsdf_c)
        w_new = torch.clamp(w_old + 1.0, max=max_weight)
        t_new = (t_old * w_old + tsdf_obs) / (w_old + 1.0)

        cupd = upd & (sdf <= trunc * 0.5) & (sdf >= -trunc * 0.5)
        pix = unpack_rgb(color_flat[lin])
        old_rgb = unpack_rgb(color_c)
        mixed = (w_new[..., None] * old_rgb + pix) / (w_new[..., None] + 1.0)
        mixed_u8 = torch.clamp(mixed, 0.0, 255.0).to(torch.uint8)

        vol.tsdf[sl] = torch.where(upd, tsdf_to_fixed(t_new), tsdf_c)
        vol.weight[sl] = torch.where(upd, w_new.to(torch.int16), weight_c)
        vol.color[sl] = torch.where(cupd, pack_rgb(mixed_u8), color_c)
