"""The streaming-volume step: `kinfu_step` with a camera-following grid
(port of kinfu_tpu/pipeline/streaming.py).

The volume's world origin is state here: a whole-voxel offset `origin_vox`
from the configured origin. Each tracked frame may shift the grid
(volume/stream.py) before it fuses, so that a point half the volume's
depth in front of the camera stays inside the volume's central box. The
step is the fixed-volume step's body (`pipeline/kinfu.py::step_with`) with
that placement: the shift is a device tensor, so nothing waits for the
device. The shift moves the state's volume in place (`shift_volume_`)
before the volume update (`pipeline/kinfu.py::update_volume`), on the
fused path and the non-fused one alike: on the card the step runs on the
kernels K1-K5 and the shift on S1 (csrc/shift_volume.cu), which the JAX
package computes outside any Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import constant, resolve_device
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, inverse, transform_points
from kinfu_tpu_torch.pipeline.kinfu import init_state, step_with, update_volume
from kinfu_tpu_torch.pipeline.state import KinFuState, StepOutput
from kinfu_tpu_torch.tracking.icp import rigid_icp
from kinfu_tpu_torch.utils.profiling import span
from kinfu_tpu_torch.volume.stream import camera_centering_shift, shift_volume_


class StreamingState(NamedTuple):
    kinfu: KinFuState
    #: whole-voxel offset of the volume origin from params.volume_origin
    origin_vox: torch.Tensor  # int32 [3] (x, y, z)


def init_streaming_state(params: KinFuParams, intr: Intrinsics,
                         device="cuda") -> StreamingState:
    """Fresh streaming state on `device` (the card unless the caller asks
    for the CPU; raises when CUDA is missing): the grid at the configured
    origin."""
    dev = resolve_device(device)
    return StreamingState(kinfu=init_state(params, intr, device=dev),
                          origin_vox=torch.zeros(3, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _grid_constants(params: KinFuParams, device):
    """(identity, base origin, voxel size, view anchor in the camera
    frame), float32 on `device`, built once per configuration."""
    return (constant([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], torch.float32, device),
            constant(params.volume_origin, torch.float32, device),
            constant(params.voxel_size, torch.float32, device),
            constant([0.0, 0.0, 0.5 * params.volume_range[2]], torch.float32, device))


def _vol_pose_dyn(params: KinFuParams, origin_vox: torch.Tensor) -> Pose:
    """World-from-volume pose of the grid placed at `origin_vox`; at
    origin 0 it has `pipeline/kinfu.py::_volume_pose`'s bits."""
    eye, base, vs, _ = _grid_constants(params, origin_vox.device)
    return Pose(eye, base + origin_vox.float() * vs)


def streaming_step(
    state: StreamingState,
    depth_mm: torch.Tensor,
    color_rgb: torch.Tensor,
    params: KinFuParams,
    intr: Intrinsics,
    margin_frac: float = 0.25,
) -> Tuple[StreamingState, StepOutput]:
    """Process one frame on the moving grid (kinfu_tpu/pipeline/streaming.py:
    62-190). The bootstrap frame does not shift; a tracked frame shifts the
    grid to keep the view anchor (half the volume depth in front of the
    camera: a forward-looking sensor needs the volume ahead of it) inside
    the central box [margin, range - margin] of each axis; a failed frame
    wipes the map and returns the grid to the configured origin. The step
    shifts and updates the volume it is given in place: the state's volume
    tensors are the new state's."""
    ks = state.kinfu
    dev = ks.vol.tsdf.device
    placed = {}

    def place(new_pose: Pose, is_first: torch.Tensor) -> Pose:
        anchor = _grid_constants(params, dev)[3]
        anchor_w = transform_points(new_pose, anchor)
        anchor_vol = transform_points(inverse(_vol_pose_dyn(params, state.origin_vox)), anchor_w)
        shift = camera_centering_shift(anchor_vol, params.volume_dims, params.voxel_size,
                                       margin_frac)
        placed["shift"] = torch.where(is_first, 0, shift)
        placed["origin"] = state.origin_vox + placed["shift"]
        return _vol_pose_dyn(params, placed["origin"])

    def track(vmaps, nmaps):
        return rigid_icp(vmaps, nmaps, ks.model_vmaps, ks.model_nmaps, intr, params)

    def update(vol, depth_m, vol2cam, cam2vol, good):
        # the JAX fail branches keep the unshifted volume; a failed frame
        # resets it here anyway, and the gate keeps the shift off it
        shift = torch.where(good, placed["shift"], 0)
        with span("kinfu.step.shift"):
            vol = shift_volume_(vol, shift)
        return update_volume(vol, depth_m, vol2cam, cam2vol, good, color_rgb=color_rgb,
                             intr=intr, params=params)

    ks_n, out = step_with(ks, depth_mm, params, intr, track, update, place=place)
    origin_n = torch.where(out.tracking_ok, placed["origin"], 0)
    return StreamingState(ks_n, origin_n), out


def make_streaming_step_fn(
    params: KinFuParams, intr: Intrinsics, margin_frac: float = 0.25
) -> Callable[[StreamingState, torch.Tensor, torch.Tensor], Tuple[StreamingState, StepOutput]]:
    """The streaming step with its configuration bound (the JAX package jits
    it and donates the state; the port runs eagerly)."""
    return functools.partial(streaming_step, params=params, intr=intr, margin_frac=margin_frac)
