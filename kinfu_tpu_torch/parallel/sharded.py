"""The sharded per-frame step: a volume sharded along Z or Y over the ranks
of a mesh, the ICP summed over row shards, halo-exchange raycasts (port of
kinfu_tpu/parallel/sharded.py).

Each rank holds one slab of the volume along the natural array dim
`mesh.shard_dim` (0 = Z, 1 = Y) and a copy of everything else (pose, model
maps, frame count); every rank is given the whole frame. Per frame:

  - **ICP**: each rank forms the normal equations of its block of image
    rows, one `psum` a iteration completes them, and every rank solves the
    same system, so the pose stays replicated (`tracking/icp.py`, K1's
    one-iteration form on the card);
  - **integrate**: each rank fuses its slab as a volume of its own, seen
    from the camera shifted by the slab's origin (K2 + K3's shard form, or
    the gather path with the origin in its voxel positions); no collective;
  - **raycast**: the warped raycast sweeps each face over the rank's slab
    padded with `HALO8` rows of its neighbours (K4's shard form, on the
    global sample grid), one `pmin` composites the six faces' hit and back
    events over the ranks (an event found in two ranks' halos lies on the
    same global plane, so the composite is exact), and every rank shades
    and resamples them (R1 `face_fields`, then K5). The march raycast
    (`raycast_mode="step"`, the CPU's default here as in JAX) marches each
    rank's t interval with a `HALO` of 3 rows (M1's slab form on the card,
    `volume/raycast.py::march_rays`), composites with a `pmin`,
    picks one winning rank a pixel and broadcasts its shading with a
    masked `psum`.

While a profiler records, each frame is the span `kinfu.shard.step`,
holding the single-device step's stage spans (`kinfu.step.frontend`,
`.icp`, `.integrate`, `.raycast`, `.reset`); inside them the halo exchange
is `kinfu.shard.halo` and each collective `kinfu.shard.collective`
(parallel/mesh.py).

The rank's volume update is the single-device one (`pipeline/kinfu.py::
update_volume`) on its slab, with the slab's offset and the rank's
raycasts. Under the fused rule (`fused_supported` of the global and the
local shape) it runs integrate, halo exchange and raycast under the
fusion's device face flags, which depend on the replicated rotation only,
so every rank launches the same kernels and meets the same collectives.
Nothing reads the device on the host: a failed frame gates the kernels
and resets each rank's slab by a multiply, as on one device. Gloo stages
CUDA tensors through the host, so the collectives themselves synchronise
there.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, pose_matrix
from kinfu_tpu_torch.numerics import recip
from kinfu_tpu_torch.ops.face_raycast import (
    RaySpec,
    Shard,
    composite_params,
    face_fields,
    faces_needed_cam2vol,
    ray_params,
    resample_composite,
    sweep_rays,
    to_camera,
)
from kinfu_tpu_torch.ops.facewarp import face_frames, primed_voxel_size, warp_dims_ok
from kinfu_tpu_torch.parallel.mesh import Mesh, halo_exchange, pmin, psum
from kinfu_tpu_torch.pipeline.kinfu import fused_supported, step_with, update_volume
from kinfu_tpu_torch.pipeline.state import KinFuState, StepOutput, state_from_numpy
from kinfu_tpu_torch.ops.icp_warped import icp_normal_eqs_warped
from kinfu_tpu_torch.tracking.icp import ICPResult, _normal_equations, icp_loop, resolve_icp_mode
from kinfu_tpu_torch.utils.profiling import span
from kinfu_tpu_torch.volume.raycast import (
    _INF,
    _rotate_t,
    march_inputs,
    march_rays,
    march_steps_bound,
    shade,
)

#: halo rows of the march raycast: its samples reach +-2.5 rows past the
#: owned slab, the trilinear gradient +-1.5 (kinfu_tpu/parallel/sharded.py:54)
HALO = 3
#: halo rows of the warped raycast: one 8-row block a side covers the
#: <= ~4.3-row drift of a ray's samples between planes (sharded.py:173-176)
HALO8 = 8


def global_shape(local_shape, mesh: Mesh) -> Tuple[int, int, int]:
    """The whole volume's [Z, Y, X] from a rank's slab."""
    return tuple(s * mesh.world if i == mesh.shard_dim else s
                 for i, s in enumerate(local_shape))


def ray_shard(frame, padded_shape, Lg: int, Ll: int, off0: int, shard_dim: int) -> Shard:
    """Where a rank's halo-padded slab lies in `frame`'s primed volume
    (sharded.py:211-235): the sharded natural dim is the face's plane axis
    or its row axis, never its lanes. A flipped face sees its planes in
    reverse, so the padded slab's first plane is global plane
    Lg - (off0 + Ll + HALO8)."""
    nat_g = tuple(Lg if i == shard_dim else padded_shape[i] for i in range(3))
    Zg, Yg = nat_g[frame.axes[0]], nat_g[frame.axes[1]]
    pos = frame.axes.index(shard_dim)
    if pos == 0:
        plane0 = Lg - (off0 + Ll + HALO8) if frame.flip else off0 - HALO8
        return Shard(Zg, Yg, plane0, 0)
    if pos != 1:
        raise ValueError(f"face {frame.name}: the sharded dim {shard_dim} is its lane axis")
    return Shard(Zg, Yg, 0, off0 - HALO8)


def _composite_local(tsdf_local: torch.Tensor, cam2vol: Pose, intr: Intrinsics,
                     params: KinFuParams, gates: torch.Tensor, mesh: Mesh):
    """The warped raycast over the mesh, in the volume frame: (vertex,
    normal, valid) of the camera grid, identical on every rank. Each face's
    sweep (K4's shard form) runs on the halo-padded slab, one `pmin`
    composites the six faces' (hit, back) over the ranks, and R1's
    six-face shading and K5's six-face composite run on every rank: the
    per-face composite of sharded.py:237-270."""
    sd = mesh.shard_dim
    size, focal = params.raycast_face
    rspec = RaySpec(size=int(size), focal=float(focal))
    Ll = tsdf_local.shape[sd]
    Lg, off0 = Ll * mesh.world, Ll * mesh.rank
    padded = halo_exchange(mesh, tsdf_local, HALO8, sd)
    prm = composite_params(cam2vol, params, sd)
    events = []
    for f, frame in enumerate(face_frames(sd)):
        vs_p = primed_voxel_size(frame, params.voxel_size)
        events.append(torch.stack(sweep_rays(
            padded, frame, ray_params(prm[f, 9:12], vs_p, rspec, gates[f]), rspec,
            ray_shard(frame, padded.shape, Lg, Ll, off0, sd))))
    events = pmin(torch.stack(events))
    t_f, n_f, _ = face_fields([e[0] for e in events], [e[1] for e in events], prm, rspec)
    return resample_composite(t_f.unbind(0), n_f.unbind(0), prm, gates, intr, rspec)


def sharded_raycast_warped(tsdf_local: torch.Tensor, cam2vol: Pose, intr: Intrinsics,
                           params: KinFuParams, mesh: Mesh,
                           gate: torch.Tensor | None = None):
    """Cube-face plane-sweep raycast over a sharded volume (sharded.py:
    273-350): replicated camera-frame (vmap, nmap), zero where there is no
    surface. The faces are the raycast's own (`faces_needed_cam2vol`);
    `gate`, a device bool, joins them."""
    gates = faces_needed_cam2vol(cam2vol, intr)
    if gate is not None:
        gates = gates & gate
    return to_camera(*_composite_local(tsdf_local, cam2vol, intr, params, gates, mesh), cam2vol)


def _local_t_interval(org_z, dir_z, z_lo, z_hi, t_start, t_end, step: float):
    """The march interval of the rays inside the slab z in [z_lo, z_hi),
    with two steps of overlap a side, as the first sample index k on the
    global grid t_start + k step and the end t (sharded.py:83-105)."""
    tiny = dir_z.abs() < 1e-12
    dz_safe = torch.where(tiny, 1e-12, dir_z)
    ta = (z_lo - org_z) / dz_safe
    tb = (z_hi - org_z) / dz_safe
    inside = (org_z >= z_lo) & (org_z < z_hi)
    t_in = torch.where(tiny, torch.where(inside, t_start, _INF), torch.minimum(ta, tb))
    t_out = torch.where(tiny, torch.where(inside, t_end, -_INF), torch.maximum(ta, tb))
    lo = torch.maximum(t_start, t_in - 2 * step)
    hi = torch.minimum(t_end, t_out + 2 * step)
    # the JAX package divides by the static step: a reciprocal multiply
    k = torch.ceil(torch.clamp(lo - t_start, min=0.0) * recip(step)).to(torch.int32)
    return k, hi


def sharded_raycast(tsdf_local: torch.Tensor, cam2vol: Pose, intr: Intrinsics,
                    params: KinFuParams, mesh: Mesh, gate: torch.Tensor | None = None):
    """The march raycast over a Z-sharded volume (sharded.py:108-170):
    replicated camera-frame (vmap, nmap). Each rank marches its slab's t
    interval on the global sample grid over its slab padded with `HALO`
    rows, one `pmin` takes the earliest hit and back event over the ranks,
    a second the one rank that owns each hit (the slab that holds its z),
    and a masked `psum` gives every rank that rank's shading. `gate`, a
    device bool, starts no ray where it is False."""
    if mesh.shard_dim != 0:
        raise NotImplementedError("the march raycast shards along Z only; a Y-sharded volume "
                                  "takes the warped raycast (warp_dims_ok)")
    Zl, Y, X = tsdf_local.shape
    n, idx = mesh.world, mesh.rank
    Zg = Zl * n
    vsz = params.voxel_size[2]
    padded = halo_exchange(mesh, tsdf_local, HALO, 0)
    z0 = idx * Zl
    org, dirs, t_start, tfar, step, inv_vs = march_inputs(cam2vol, intr, params)
    if gate is not None:
        tfar = torch.where(gate, tfar, -_INF)
    z_lo = float(np.float32(z0) * np.float32(vsz))
    z_hi = float(np.float32(z0 + Zl) * np.float32(vsz))
    k_lo, t_hi = _local_t_interval(org[2], dirs[..., 2], z_lo, z_hi, t_start, tfar, step)
    dims_g = (Zg, Y, X)
    res = march_rays(padded, dims_g, z0 - HALO, org, dirs, t_start, t_hi, step, inv_vs,
                     k_start=k_lo, max_steps=march_steps_bound(dims_g, params.voxel_size, step))

    hit_t, back_t = pmin(torch.stack([res.hit_t, res.back_t]))
    hit = (hit_t < back_t) & (hit_t < _INF)
    # one winner a pixel: the rank whose half-open slab holds the hit's z
    # (the intervals overlap by two steps, so neighbours may find the same
    # crossing); hits outside every slab fall to the first or last rank
    hit_z = org[2] + dirs[..., 2] * hit_t
    owned = (hit_z >= z_lo) & (hit_z < z_hi)
    if idx == 0:
        owned = owned | (hit_z < 0.0)
    if idx == n - 1:
        owned = owned | (hit_z >= float(np.float32(vsz) * np.float32(Zg)))
    mine = hit & (res.hit_t <= hit_t) & owned
    winner = pmin(torch.where(mine, idx, n).to(torch.int32))
    i_shade = mine & (winner == idx)

    vertex, nrm, valid = shade(padded, dims_g, z0 - HALO, org, dirs, hit_t, i_shade,
                               params.voxel_size)
    R, _ = cam2vol
    mask = (valid & i_shade).float()[..., None]
    out = psum(torch.stack([_rotate_t(R, vertex - org) * mask, _rotate_t(R, nrm) * mask]))
    return out[0], out[1]


def resolve_raycast_mode(params: KinFuParams, local_shape, mesh: Mesh, device) -> str:
    """"warped" or "step" for the non-fused sharded step (sharded.py:
    652-683): "auto" is "warped" on a CUDA device where the global shape
    passes `warp_dims_ok` and the slab is whole 8-row blocks, else
    "step"; every other mode but an eligible "warped" marches."""
    warp_ok = (warp_dims_ok(global_shape(local_shape, mesh), mesh.shard_dim)
               and local_shape[mesh.shard_dim] % 8 == 0)
    mode = params.raycast_mode
    if mode == "auto":
        mode = "warped" if torch.device(device).type == "cuda" and warp_ok else "step"
    return "warped" if mode == "warped" and warp_ok else "step"


def row_shard(img: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of image rows, after zero rows pad the image to a
    multiple of the world size (sharded.py:545-559): a zero row has zero
    normals, which the correspondence mask rejects, so the padding adds
    nothing to the sums."""
    rows = -(-img.shape[0] // mesh.world)
    pad = rows * mesh.world - img.shape[0]
    if pad:
        img = torch.cat([img, img.new_zeros((pad, *img.shape[1:]))])
    return img[mesh.rank * rows:(mesh.rank + 1) * rows]


def rigid_icp_local(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr: Intrinsics,
                    params: KinFuParams, mesh: Mesh) -> ICPResult:
    """K1's row-shard form (kinfu_tpu/tracking/icp.py:150-199 with an axis
    name): `tracking/icp.py::rigid_icp` with the current maps the rank's
    row shards (`row_shard`). Each iteration forms the rank's normal
    equations (K1's one-iteration form on the card, or the gather path),
    sums (A, b, count) over the mesh in one `psum`, and every rank runs
    the same `finish_iteration`. The count crosses as float32, exact below
    2^24."""
    eqs = (_normal_equations if resolve_icp_mode(params, cur_vmaps[0].device) == "gather"
           else icp_normal_eqs_warped)

    def summed(*args):
        A, b, n = eqs(*args)
        tot = psum(torch.cat([A.reshape(36), b, n.reshape(1).float()]))
        return tot[:36].reshape(6, 6), tot[36:42], tot[42].to(torch.int32)

    return icp_loop(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr, params, summed)


def kinfu_step_local(state: KinFuState, depth_mm: torch.Tensor, color_rgb: torch.Tensor,
                     params: KinFuParams, intr: Intrinsics, mesh: Mesh
                     ) -> Tuple[KinFuState, StepOutput]:
    """One rank's sharded step (sharded.py:562-718): `pipeline/kinfu.py::
    kinfu_step` with the ICP over the rank's row shards and `update_volume`
    on the rank's slab. Under the fused rule of the global and the local
    shape (on a CUDA device by default, as on one device) its raycast is
    the warped composite over the mesh (`_composite_local`), else the
    sharded raycast of `resolve_raycast_mode`; either gathers the
    camera-frame maps on every rank. `state` holds the rank's slab
    (`shard_state`); the frame is the whole one, on the state's device. A
    failed frame resets the state."""
    sd = mesh.shard_dim
    shape, dev = state.vol.tsdf.shape, state.vol.tsdf.device
    march = (sharded_raycast_warped
             if resolve_raycast_mode(params, shape, mesh, dev) == "warped" else sharded_raycast)

    def track(vmaps, nmaps):
        return rigid_icp_local([row_shard(v, mesh) for v in vmaps],
                               [row_shard(n, mesh) for n in nmaps],
                               state.model_vmaps, state.model_nmaps, intr, params, mesh)

    update = functools.partial(
        update_volume, color_rgb=color_rgb, intr=intr, params=params,
        fused=(fused_supported(global_shape(shape, mesh), params, dev, sd)
               and fused_supported(shape, params, dev, sd)),
        composite=functools.partial(_composite_local, mesh=mesh),
        raycast=lambda vol, c2v, i, p, gate: march(vol.tsdf, c2v, i, p, mesh, gate=gate),
        z_offset=shape[sd] * mesh.rank, shard_dim=sd)
    return step_with(state, depth_mm, params, intr, track, update)


def make_sharded_step_fn(params: KinFuParams, intr: Intrinsics, mesh: Mesh):
    """The rank's step `step(state, depth_mm, color_rgb)` with its
    configuration and mesh bound (sharded.py:735-755; the JAX package jits
    a `shard_map` of it), each call inside the span `kinfu.shard.step`."""

    def step(state: KinFuState, depth_mm: torch.Tensor, color_rgb: torch.Tensor):
        with span("kinfu.shard.step"):
            return kinfu_step_local(state, depth_mm, color_rgb, params, intr, mesh)

    return step


def init_state_local(params: KinFuParams, intr: Intrinsics, mesh: Mesh) -> KinFuState:
    """A fresh state of this rank on its device: `shard_state` of
    `init_state`, without building the whole volume first."""
    from kinfu_tpu_torch.pipeline.kinfu import init_state

    sd = mesh.shard_dim
    dims = list(params.volume_dims)  # x, y, z
    if dims[2 - sd] % mesh.world:
        raise ValueError(f"{dims[2 - sd]} planes along dim {sd} do not split over "
                         f"{mesh.world} ranks")
    dims[2 - sd] //= mesh.world
    return init_state(params.replace(volume_dims=tuple(dims)), intr, device=mesh.device)


def _host_fields(state) -> dict:
    """A state as the numpy fields of `state_from_numpy`: a mapping in that
    layout as it is, or a state of either package (`vol`, `pose` (R, t),
    `model_vmaps`, `model_nmaps`, `frame_count`), copied to the host."""
    if isinstance(state, Mapping):
        return dict(state)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = np.asarray(state.pose[0]), np.asarray(state.pose[1])
    host = (lambda a: a.detach().cpu().numpy()) if isinstance(state.vol.tsdf, torch.Tensor) \
        else np.asarray
    return dict(tsdf=host(state.vol.tsdf), weight=host(state.vol.weight),
                color=host(state.vol.color), pose=T,
                model_vmaps=[host(m) for m in state.model_vmaps],
                model_nmaps=[host(m) for m in state.model_nmaps],
                frame_count=host(state.frame_count))


def shard_state(state, mesh: Mesh) -> KinFuState:
    """This rank's part of a whole state on the rank's device
    (sharded.py:758-769): its slab of the volume along `mesh.shard_dim`,
    and everything else whole. `state` is a state of either package or
    the numpy fields of `state_from_numpy`."""
    d = _host_fields(state)
    sd = mesh.shard_dim
    L = d["tsdf"].shape[sd]
    if L % mesh.world:
        raise ValueError(f"{L} planes along dim {sd} do not split over {mesh.world} ranks")
    Ll = L // mesh.world
    sl = [slice(None)] * 3
    sl[sd] = slice(mesh.rank * Ll, (mesh.rank + 1) * Ll)
    for k in ("tsdf", "weight", "color"):
        d[k] = np.asarray(d[k])[tuple(sl)]
    return state_from_numpy(d, device=mesh.device)


def unshard_state(state: KinFuState, mesh: Mesh) -> dict:
    """The whole state, gathered from every rank's slab, as the numpy
    fields of `state_to_numpy` on every rank (a collective: every rank
    calls it). The slabs cross as int32 words (the int16 fields two
    voxels a word), on the card with NCCL and through the host with gloo."""
    sd = mesh.shard_dim

    def gather(a: torch.Tensor) -> np.ndarray:
        x = a if mesh.backend == "nccl" else a.cpu()
        x = x.contiguous().view(torch.int32) if x.dtype == torch.int16 else x
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x)
        return torch.cat([p.view(a.dtype) for p in parts], dim=sd).cpu().numpy()

    def host(a):
        return a.detach().cpu().numpy().copy()

    return dict(tsdf=gather(state.vol.tsdf), weight=gather(state.vol.weight),
                color=gather(state.vol.color), pose=host(pose_matrix(state.pose)),
                model_vmaps=[host(m) for m in state.model_vmaps],
                model_nmaps=[host(m) for m in state.model_nmaps],
                frame_count=host(state.frame_count))
