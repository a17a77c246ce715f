"""The per-frame pipeline step and the relocalization step (port of
kinfu_tpu/pipeline/kinfu.py).

  measurement pyramid -> ICP -> integrate + raycast + reset -> state'

As in the JAX package, the bootstrap merges into the main path: ICP runs
every frame (on frame 1 the model maps are zero and its result is
discarded), and the per-frame choices (bootstrap, tracked, failed) are
`torch.where` selects on device tensors, so a step never waits for the
device. The step updates the volume of the state it is given in place.

One volume update serves the step, `update_volume`: the integrate and
raycast dispatchers (`volume/`) in the place of the JAX step's
`lax.cond(good, fuse, fail)` and of its fused step's single `lax.switch`.
Under the fused rule (`fused_supported`) both run the warped kernels under
the fusion's face flags; otherwise each runs its configured mode. The
device flag `good` gates them: a failed frame writes nothing into the
volume and raycasts nothing, and the reset, where asked for, multiplies
the volume by the flag. `relocalize_step` keeps the state it is given
untouched on failure the same way.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import constant, resolve_device
from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid, resize_points_normals
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import (
    Pose,
    compose,
    identity_pose,
    inverse,
    pose_from_matrix,
    pose_matrix,
)
from kinfu_tpu_torch.ops.face_integrate import faces_needed
from kinfu_tpu_torch.ops.face_raycast import face_composite, to_camera
from kinfu_tpu_torch.ops.facewarp import warp_dims_ok
from kinfu_tpu_torch.pipeline.state import KinFuState, StepOutput
from kinfu_tpu_torch.tracking.icp import rigid_icp
from kinfu_tpu_torch.utils.profiling import span
from kinfu_tpu_torch.volume.integrate import integrate
from kinfu_tpu_torch.volume.raycast import raycast
from kinfu_tpu_torch.volume.tsdf import TSDFVolume, create_volume, reset_failed_


def init_state(params: KinFuParams, intr: Intrinsics, device="cuda") -> KinFuState:
    """Fresh session state on `device` (the card unless the caller asks for
    the CPU; raises when CUDA is missing)."""
    dev = resolve_device(device)
    vmaps, nmaps = [], []
    for level in range(params.pyramid_height):
        li = intr.level(level)
        vmaps.append(torch.zeros((li.height, li.width, 3), dtype=torch.float32, device=dev))
        nmaps.append(torch.zeros((li.height, li.width, 3), dtype=torch.float32, device=dev))
    return KinFuState(
        vol=create_volume(params.volume_dims, device=dev),
        pose=identity_pose(dev),
        model_vmaps=tuple(vmaps),
        model_nmaps=tuple(nmaps),
        frame_count=torch.ones((), dtype=torch.int32, device=dev),
    )


@functools.lru_cache(maxsize=None)
def _volume_pose(params: KinFuParams, device) -> Pose:
    """World-from-volume pose on `device`, built once per configuration
    (no host copy in the step)."""
    return pose_from_matrix(constant(params.volume_pose, torch.float32, device))


def _model_pyramid(vmap0, nmap0, levels: int):
    vmaps, nmaps = [vmap0], [nmap0]
    for _ in range(1, levels):
        v, n = resize_points_normals(vmaps[-1], nmaps[-1])
        vmaps.append(v)
        nmaps.append(n)
    return tuple(vmaps), tuple(nmaps)


def _where_pose(cond: torch.Tensor, a: Pose, b: Pose) -> Pose:
    return Pose(torch.where(cond, a.R, b.R), torch.where(cond, a.t, b.t))


def _measurement(depth_mm: torch.Tensor, params: KinFuParams, intr: Intrinsics):
    """(depth, vertex, normal) pyramids of a raw depth frame."""
    return build_measurement_pyramid(
        depth_mm,
        intr,
        pyramid_height=params.pyramid_height,
        bfilter_kernel_size=params.bfilter_kernel_size,
        bfilter_color_sigma=params.bfilter_color_sigma,
        bfilter_spatial_sigma=params.bfilter_spatial_sigma,
        depth_scale=params.depth_scale,
        max_dist=params.dfilter_dist,
        normal_disc_threshold=params.normal_disc_threshold,
    )


def _finite_pose(p: Pose) -> Pose:
    """`p`, or the identity when any entry is non-finite (a singular ICP
    solve): the whole matrix is replaced, never single entries. The JAX
    sharded update repairs single entries (kinfu_tpu/parallel/sharded.py:
    427-428), which does not leave a rotation; every update here repairs
    as the JAX single-device steps do."""
    ok = torch.isfinite(p.R).all() & torch.isfinite(p.t).all()
    return _where_pose(ok, p, identity_pose(p.R.device))


def fused_supported(shape, params: KinFuParams, device, shard_dim: int | None = None) -> bool:
    """The fused rule: True when `update_volume` runs the warped integrate
    and raycast under the fusion's face flags. It asks for `fused_mode`
    "on" (the kernels' plain versions off CUDA) or "auto" on a CUDA device,
    integrate and raycast modes "auto" or "warped", and `warp_dims_ok` of
    the volume's (Z, Y, X) `shape` in the `shard_dim` frame set. A rank of
    a sharded volume asks it of its global and its local shape."""
    modes_ok = params.integrate_mode in ("auto", "warped") and (
        params.raycast_mode in ("auto", "warped"))
    device_ok = params.fused_mode == "on" or (
        params.fused_mode == "auto" and torch.device(device).type == "cuda")
    return modes_ok and device_ok and warp_dims_ok(tuple(shape), shard_dim)


def update_volume(vol: TSDFVolume, depth_m: torch.Tensor, vol2cam: Pose, cam2vol: Pose,
                  good: torch.Tensor, *, color_rgb: torch.Tensor, intr: Intrinsics,
                  params: KinFuParams, reset_on_fail: bool = True, fused: bool | None = None,
                  composite=face_composite, raycast=raycast, z_offset: int = 0,
                  shard_dim: int = 0):
    """The volume update (kinfu_tpu/pipeline/kinfu.py:167-197 and
    kinfu_tpu/ops/fused_step.py): fuse the frame into `vol` in place, then
    raycast the fused volume. Returns (vol, vmap, nmap): camera-frame maps,
    zero where `good` (a device bool) is False; the volume is then reset
    when reset_on_fail, else kept for a relocalizer.

    Under the fused rule (`fused`, by default `fused_supported` of the
    volume), the fusion's face flags (`faces_needed` and `good`), computed
    once, gate the warped integrate and `composite(tsdf, cam2vol, intr,
    params, flags)`, which sweeps from `cam2vol` as given; its maps turn
    to the camera frame by the repaired pose (`_finite_pose`). Otherwise
    the integrate dispatcher runs its mode gated by `good`, and
    `raycast(vol, cam2vol, intr, params, gate=good)` starts from the
    repaired pose. The JAX fused step's `lax.switch` is TPU staging and has
    no counterpart here, and K7 (`pin_natural`, which pins the switch
    results' TPU layout) is the identity: the volume keeps its layout.

    One rank of a sharded volume (parallel/sharded.py) passes its slab's
    `z_offset` and `shard_dim`, `fused` and its two raycasts. While a
    profiler records, the stages are the spans `kinfu.step.integrate`,
    `.raycast` and `.reset`."""
    if fused is None:
        fused = fused_supported(vol.tsdf.shape, params, vol.tsdf.device)
    with span("kinfu.step.integrate"):
        faces = faces_needed(vol2cam, intr) & good if fused else None
        integrate(vol, depth_m, color_rgb, vol2cam, intr, params, z_offset, shard_dim,
                  gate=None if fused else good, faces=faces)
    with span("kinfu.step.raycast"):
        if fused:
            vmap, nmap = to_camera(*composite(vol.tsdf, cam2vol, intr, params, faces),
                                   _finite_pose(cam2vol))
        else:
            vmap, nmap = raycast(vol, _finite_pose(cam2vol), intr, params, gate=good)
    if reset_on_fail:
        with span("kinfu.step.reset"):
            reset_failed_(vol, good)
    return vol, vmap, nmap


def kinfu_step(
    state: KinFuState,
    depth_mm: torch.Tensor,
    color_rgb: torch.Tensor,
    params: KinFuParams,
    intr: Intrinsics,
    auto_reset: bool = True,
) -> Tuple[KinFuState, StepOutput]:
    """Process one frame. depth_mm: [H, W] float32 raw depth (mm-scale);
    color_rgb: [H, W, 3] uint8; both on the state's device.

    auto_reset=True wipes map and pose on a tracking failure
    (kinectfusion.cpp:97-102); auto_reset=False keeps the state for a
    relocalizer. The volume update is `update_volume` (on the CPU, "auto"
    is the gather integrate and the "hier" raycast, as in the JAX
    package); either ICP mode (`tracking/icp.py::resolve_icp_mode`)."""

    def track(vmaps, nmaps):
        return rigid_icp(vmaps, nmaps, state.model_vmaps, state.model_nmaps, intr, params)

    update = functools.partial(update_volume, color_rgb=color_rgb, intr=intr, params=params,
                               reset_on_fail=auto_reset)
    return step_with(state, depth_mm, params, intr, track, update, auto_reset)


def step_with(state: KinFuState, depth_mm: torch.Tensor, params: KinFuParams,
              intr: Intrinsics, track, update, auto_reset: bool = True, place=None
              ) -> Tuple[KinFuState, StepOutput]:
    """The step around its two parts: `track(vmaps, nmaps)`, the ICP of the
    measurement pyramids against the state's model maps (an `ICPResult`),
    and `update(vol, depth_m, vol2cam, cam2vol, good)`, the volume update,
    which returns (vol, vmap, nmap). `kinfu_step` passes the single-device
    ones, the sharded step (parallel/sharded.py) the rank's. `place(new_pose,
    is_first)`, if given, returns the frame's world-from-volume pose (the
    streaming step's moving grid, pipeline/streaming.py); by default it is
    the configured fixed one. While a profiler records, the measurement is
    the span `kinfu.step.frontend` and `track` is `kinfu.step.icp`; the
    update's own spans are `kinfu.step.integrate`, `.raycast` and `.reset`
    (`update_volume`), after the streaming step's `kinfu.step.shift`."""
    dev = state.vol.tsdf.device

    with span("kinfu.step.frontend"):
        dmaps, vmaps, nmaps = _measurement(depth_mm, params, intr)

    is_first = state.frame_count == 1
    with span("kinfu.step.icp"):
        icp = track(vmaps, nmaps)
    good = (icp.ok & ~is_first) | is_first

    # frame 1 fuses at the held pose; tracked frames right-multiply the
    # ICP increment
    new_pose = _where_pose(is_first, state.pose, compose(state.pose, icp.pose))
    vol_pose = _volume_pose(params, dev) if place is None else place(new_pose, is_first)
    vol2cam = compose(inverse(new_pose), vol_pose)
    cam2vol = compose(inverse(vol_pose), new_pose)

    vol_n, rv, rn = update(state.vol, dmaps[0], vol2cam, cam2vol, good)
    mv, mn = _model_pyramid(rv, rn, params.pyramid_height)
    mv = tuple(torch.where(is_first, a, b) for a, b in zip(vmaps, mv))
    mn = tuple(torch.where(is_first, a, b) for a, b in zip(nmaps, mn))
    if not auto_reset:
        # failure keeps the old prediction maps for the relocalizer
        mv = tuple(torch.where(good, a, b) for a, b in zip(mv, state.model_vmaps))
        mn = tuple(torch.where(good, a, b) for a, b in zip(mn, state.model_nmaps))

    if auto_reset:
        fail_pose = identity_pose(dev)
        fail_fc = torch.ones((), dtype=torch.int32, device=dev)
    else:
        fail_pose = state.pose
        fail_fc = state.frame_count
    pose_n = _where_pose(good, new_pose, fail_pose)
    fc_n = torch.where(
        good,
        torch.where(is_first, torch.full_like(state.frame_count, 2), state.frame_count + 1),
        fail_fc,
    )
    new_state = KinFuState(
        vol=vol_n, pose=pose_n, model_vmaps=mv, model_nmaps=mn, frame_count=fc_n
    )
    out = StepOutput(
        pose_matrix=pose_matrix(pose_n),
        tracking_ok=good,
        icp_inliers=torch.where(is_first, torch.zeros_like(icp.num_inliers),
                                icp.num_inliers),
    )
    return new_state, out


def make_step_fn(
    params: KinFuParams, intr: Intrinsics, auto_reset: bool = True
) -> Callable[[KinFuState, torch.Tensor, torch.Tensor], Tuple[KinFuState, StepOutput]]:
    """The step with its configuration bound (the JAX package jits it; the
    port runs eagerly)."""
    return functools.partial(kinfu_step, params=params, intr=intr, auto_reset=auto_reset)


def relocalize_step(
    state: KinFuState,
    depth_mm: torch.Tensor,
    color_rgb: torch.Tensor,
    seed_pose,
    params: KinFuParams,
    intr: Intrinsics,
) -> Tuple[KinFuState, StepOutput]:
    """One relocalization attempt against the kept map
    (kinfu_tpu/pipeline/kinfu.py:235-302).

    Raycasts the volume from `seed_pose` (a 4x4 world-from-camera guess,
    typically the nearest keyframe's, mapping/keyframes.py; a tensor on the
    state's device or a host array), runs ICP of the current measurement
    against that prediction, and on success re-enters normal tracking:
    integrate at the recovered pose and fresh model maps. On failure the
    state is left as it was: the ICP flag gates the integrate and the
    raycast, and selects pose, maps and frame count, so nothing waits for
    the device. The volume is updated in place."""
    dev = state.vol.tsdf.device
    vol_pose = _volume_pose(params, dev)
    if not isinstance(seed_pose, torch.Tensor):
        seed_pose = constant(seed_pose, torch.float32, dev)
    seed = pose_from_matrix(seed_pose.to(device=dev, dtype=torch.float32))

    dmaps, vmaps, nmaps = _measurement(depth_mm, params, intr)

    # model prediction from the seed pose
    rv, rn = raycast(state.vol, compose(inverse(vol_pose), seed), intr, params)
    mv, mn = _model_pyramid(rv, rn, params.pyramid_height)
    icp = rigid_icp(vmaps, nmaps, mv, mn, intr, params)
    ok = icp.ok

    new_pose = compose(seed, icp.pose)
    vol2cam = compose(inverse(new_pose), vol_pose)
    integrate(state.vol, dmaps[0], color_rgb, vol2cam, intr, params, gate=ok)
    cam2vol = compose(inverse(vol_pose), new_pose)
    rv2, rn2 = raycast(state.vol, _finite_pose(cam2vol), intr, params, gate=ok)
    mv2, mn2 = _model_pyramid(rv2, rn2, params.pyramid_height)

    pose_n = _where_pose(ok, new_pose, state.pose)
    new_state = KinFuState(
        vol=state.vol,
        pose=pose_n,
        model_vmaps=tuple(torch.where(ok, a, b) for a, b in zip(mv2, state.model_vmaps)),
        model_nmaps=tuple(torch.where(ok, a, b) for a, b in zip(mn2, state.model_nmaps)),
        frame_count=torch.where(ok, state.frame_count + 1, state.frame_count),
    )
    out = StepOutput(pose_matrix=pose_matrix(pose_n), tracking_ok=ok,
                     icp_inliers=icp.num_inliers)
    return new_state, out
