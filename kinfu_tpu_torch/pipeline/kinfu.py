"""The per-frame pipeline step and the relocalization step (port of
kinfu_tpu/pipeline/kinfu.py).

  measurement pyramid -> ICP -> integrate + raycast + reset -> state'

As in the JAX package, the bootstrap merges into the main path: ICP runs
every frame (on frame 1 the model maps are zero and its result is
discarded), and the per-frame choices (bootstrap, tracked, failed) are
`torch.where` selects on device tensors, so a step never waits for the
device. The step updates the volume of the state it is given in place.

Two volume updates serve the step: the fused update (`ops/fused_step.py`,
the JAX package's single `lax.switch`) and the non-fused one, the
`integrate` and `raycast` dispatchers (`volume/`) in the place of the JAX
step's `lax.cond(good, fuse, fail)`. Its device flag `good` gates the
dispatchers instead: a failed frame writes nothing into the volume and
raycasts nothing, and the reset, where asked for, multiplies the volume
by the flag as the fused update does. `relocalize_step` keeps the state it
is given untouched on failure the same way.
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
from kinfu_tpu_torch.ops.fused_step import fused_supported, fused_update
from kinfu_tpu_torch.pipeline.state import KinFuState, StepOutput
from kinfu_tpu_torch.tracking.icp import rigid_icp
from kinfu_tpu_torch.utils.profiling import span
from kinfu_tpu_torch.volume.integrate import integrate
from kinfu_tpu_torch.volume.raycast import raycast
from kinfu_tpu_torch.volume.tsdf import TSDFVolume, create_volume


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
    solve): the whole matrix is replaced, never single entries."""
    ok = torch.isfinite(p.R).all() & torch.isfinite(p.t).all()
    return _where_pose(ok, p, identity_pose(p.R.device))


def _update(vol: TSDFVolume, depth_m, color_rgb, vol2cam: Pose, cam2vol: Pose,
            intr: Intrinsics, params: KinFuParams, good: torch.Tensor,
            reset_on_fail: bool = True):
    """The non-fused volume update (kinfu_tpu/pipeline/kinfu.py:167-197):
    integrate, then raycast the fused volume, both gated by `good`.
    Returns (vol, vmap, nmap) with the fused update's contract: the maps
    are zero where `good` is False, and the volume is then reset when
    reset_on_fail, else kept for a relocalizer."""
    with span("kinfu.step.integrate"):
        integrate(vol, depth_m, color_rgb, vol2cam, intr, params, gate=good)
    with span("kinfu.step.raycast"):
        rv, rn = raycast(vol, _finite_pose(cam2vol), intr, params, gate=good)
    if reset_on_fail:
        with span("kinfu.step.reset"):
            for a in vol:
                a.mul_(good.to(a.dtype))
    return vol, rv, rn


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
    relocalizer. The fused update serves the configurations of
    `fused_supported`, the integrate and raycast dispatchers every other
    one (on the CPU, "auto" is the gather integrate and the "hier"
    raycast, as in the JAX package); either ICP mode
    (`tracking/icp.py::resolve_icp_mode`)."""

    def track(vmaps, nmaps):
        return rigid_icp(vmaps, nmaps, state.model_vmaps, state.model_nmaps, intr, params)

    def update(vol, depth_m, vol2cam, cam2vol, good):
        if fused_supported(vol.tsdf.shape, params, vol.tsdf.device):
            return fused_update(vol, depth_m, color_rgb, vol2cam, cam2vol, intr, params, good,
                                reset_on_fail=auto_reset)
        return _update(vol, depth_m, color_rgb, vol2cam, cam2vol, intr, params, good,
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
    update's own spans are `kinfu.step.shift`, `.integrate`, `.raycast`
    and `.reset`."""
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
