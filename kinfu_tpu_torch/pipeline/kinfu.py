"""The per-frame pipeline step (port of kinfu_tpu/pipeline/kinfu.py).

  measurement pyramid -> ICP -> fused integrate + raycast + reset -> state'

As in the JAX package, the bootstrap merges into the main path: ICP runs
every frame (on frame 1 the model maps are zero and its result is
discarded), and the per-frame choices (bootstrap, tracked, failed) are
`torch.where` selects on device tensors, so a step never waits for the
device. The step updates the volume of the state it is given in place.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import resolve_device
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
from kinfu_tpu_torch.volume.tsdf import create_volume


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


def _volume_pose(params: KinFuParams, device) -> Pose:
    return pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))


def _model_pyramid(vmap0, nmap0, levels: int):
    vmaps, nmaps = [vmap0], [nmap0]
    for _ in range(1, levels):
        v, n = resize_points_normals(vmaps[-1], nmaps[-1])
        vmaps.append(v)
        nmaps.append(n)
    return tuple(vmaps), tuple(nmaps)


def _where_pose(cond: torch.Tensor, a: Pose, b: Pose) -> Pose:
    return Pose(torch.where(cond, a.R, b.R), torch.where(cond, a.t, b.t))


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
    relocalizer. Only the fused step is ported, with either ICP mode
    (`tracking/icp.py::resolve_icp_mode`): other configurations raise
    NotImplementedError."""
    dev = state.vol.tsdf.device
    if not fused_supported(state.vol.tsdf.shape, params, dev):
        raise NotImplementedError(
            "only the fused warped step is ported (fused_mode='on', or 'auto' on "
            "CUDA, with warped integrate/raycast and warp_dims_ok volume dims; "
            "either ICP mode); the non-fused step with the gather/hier integrate "
            "and raycast paths is ROADMAP.md queue 1, items 4 and 5"
        )
    vol_pose = _volume_pose(params, dev)

    dmaps, vmaps, nmaps = build_measurement_pyramid(
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

    is_first = state.frame_count == 1
    icp = rigid_icp(vmaps, nmaps, state.model_vmaps, state.model_nmaps, intr, params)
    good = (icp.ok & ~is_first) | is_first

    # frame 1 fuses at the held pose; tracked frames right-multiply the
    # ICP increment
    new_pose = _where_pose(is_first, state.pose, compose(state.pose, icp.pose))
    vol2cam = compose(inverse(new_pose), vol_pose)
    cam2vol = compose(inverse(vol_pose), new_pose)

    vol_n, rv, rn = fused_update(
        state.vol, dmaps[0], color_rgb, vol2cam, cam2vol, intr, params, good,
        reset_on_fail=auto_reset,
    )
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
