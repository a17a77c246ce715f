"""The fused volume update: integrate + raycast + failure reset (port of
kinfu_tpu/ops/fused_step.py).

The JAX package folds these into one `lax.switch` (6 single-face branches,
a multi-face chain and a fail branch, L152-217) so that the TPU volume
crosses one conditional per frame. In eager PyTorch there is no staging to
save, so the port keeps what the switch computed and drops how:

  - one launch of K2 builds the six face stacks, then a loop over the six
    faces sweeps them; each kernel reads the device flag
    `faces_needed[f] & good` and writes nothing for a face where it is 0,
    so no Python branch reads the device;
  - the raycast's resample and composite over the faces (L132-144) is one
    launch of K5 for all six faces, which also reads those flags;
  - on failure the volume is reset by multiplying it in place with a device
    0/1 scalar, as the fail branch does (L197-211);
  - `pin_natural` (kinfu_tpu/ops/layout_pin.py), which pins TPU layouts
    across the switch, is the identity here and has no counterpart;
  - `aux` threading and multiply-masks become plain `torch.where`.
"""

from __future__ import annotations

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.ops.face_integrate import faces_needed, integrate_faces
from kinfu_tpu_torch.ops.face_raycast import (
    RaySpec,
    composite_params,
    resample_composite,
    sweep_and_shade,
)
from kinfu_tpu_torch.ops.facewarp import default_face_spec, face_frames, warp_dims_ok
from kinfu_tpu_torch.volume.tsdf import TSDFVolume, pack_rgb


def fused_supported(vol_shape, params: KinFuParams, device: torch.device) -> bool:
    """True when the fused path serves this configuration: "on" anywhere
    (plain versions on the CPU), "auto" on a CUDA device."""
    if params.fused_mode == "off":
        return False
    modes_ok = params.integrate_mode in ("auto", "warped") and (
        params.raycast_mode in ("auto", "warped")
    )
    if params.fused_mode == "on":
        return modes_ok and warp_dims_ok(vol_shape)
    return modes_ok and torch.device(device).type == "cuda" and warp_dims_ok(vol_shape)


def fused_update(
    vol: TSDFVolume,
    depth_m: torch.Tensor,
    color_rgb: torch.Tensor,
    vol2cam: Pose,
    cam2vol: Pose,
    intr: Intrinsics,
    params: KinFuParams,
    good: torch.Tensor,
    reset_on_fail: bool = True,
):
    """Fuse the frame into `vol` in place, then raycast the fused volume.

    Returns (vol, vmap [H,W,3], nmap [H,W,3]): the camera-frame prediction,
    zeros where `good` (a device bool) is False; the volume is then reset
    when reset_on_fail, else kept for a relocalizer."""
    size, focal = params.raycast_face
    rspec = RaySpec(size=int(size), focal=float(focal))
    fspec = default_face_spec()
    dev = depth_m.device
    R, tt = cam2vol
    # whole-matrix replacement of a non-finite pose (L106-114): element-wise
    # repair of a partly-NaN R would not be a rotation
    pose_ok = torch.isfinite(R).all() & torch.isfinite(tt).all()
    R = torch.where(pose_ok, R, torch.eye(3, dtype=R.dtype, device=dev))
    org = torch.where(pose_ok, tt, torch.zeros_like(tt))

    gates = faces_needed(vol2cam, intr) & good
    integrate_faces(vol, depth_m, pack_rgb(color_rgb), vol2cam, intr, params, fspec, gates)
    frames = face_frames()
    # K7, kinfu_tpu/ops/layout_pin.py::pin_natural, pins the switch results'
    # TPU layout at this point; the volume here is updated in place and keeps
    # its layout, so its port is the identity

    prm = composite_params(cam2vol, params)
    fields = [sweep_and_shade(vol.tsdf, frame, prm[f, 9:12], params, rspec, gates[f])
              for f, frame in enumerate(frames)]
    vertex, normal, valid = resample_composite(
        [t for t, _ in fields], [n for _, n in fields], prm, gates, intr, rspec)

    # failure: reset (kinectfusion.cpp:97-102) or keep for the relocalizer
    keep = good | (not reset_on_fail)
    vol.tsdf.mul_(keep.to(torch.int16))
    vol.weight.mul_(keep.to(torch.int16))
    vol.color.mul_(keep.to(torch.int32))

    vcam = (vertex - org) @ R
    ncam = normal @ R
    return vol, torch.where(valid[..., None], vcam, 0.0), torch.where(valid[..., None], ncam, 0.0)
