"""Raycast parity at the main path's size: the warped plane sweep (K4 and
K5, `ops/face_raycast.py::raycast_warped`) against the unit-step march
(`volume/raycast.py`, raycast_mode="step"), the counterpart of
tools/raycast_parity_probe.py and the port's evidence for DIVERGENCES.md
item 20 (the reference's target: the march hits a pixel the sweep misses
on under 1% of pixels, ACCURACY.md).

One frame of the orbit's scene at the identity pose is fused into a fresh
volume (the `integrate` dispatcher), then both raycasts run from that pose.
Prints one JSON line: the share of pixels whose hit masks agree, the
shares where only the march or only the sweep hits, and on the pixels both
hit the median vertex gap (mm) and normal angle (degrees), unrounded.

    python -m kinfu_tpu_torch.tools.raycast_parity_probe [--dim 512]
        [--width 640 --height 480] [--device cuda|cpu]

The "step" march reads the device once a loop step (`any(alive)`): fine
for a probe, which is not the step.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def parity_stats(vm_w, nm_w, vm_r, nm_r) -> dict:
    """The probe's numbers from the sweep's (vm_w, nm_w) and the march's
    (vm_r, nm_r) camera-frame maps [H, W, 3] (numpy): a pixel is hit where
    its normal is non-zero."""
    hw = np.any(nm_w != 0, -1)
    hr = np.any(nm_r != 0, -1)
    both = hw & hr
    dv = np.linalg.norm(vm_w - vm_r, axis=-1)[both]
    nang = np.degrees(np.arccos(np.clip(np.sum(nm_w * nm_r, -1)[both], -1, 1)))
    return {"agree": float((hw == hr).mean()),
            "march_hits_sweep_misses": float((hr & ~hw).mean()),
            "sweep_hits_march_misses": float((~hr & hw).mean()),
            "dv_med_mm": float(np.median(dv)) * 1e3 if dv.size else float("nan"),
            "nang_med_deg": float(np.median(nang)) if nang.size else float("nan")}


def face_counts(weight, normal, cam2vol, intr, params) -> dict:
    """{face name: (fused voxels, hit pixels)} by the cube face that owns
    their direction from the camera: the voxels of `weight` [Z, Y, X] > 0
    (at iota * voxel size, as the gather integrate places them) and the
    pixels whose camera-frame `normal` [H, W, 3] is non-zero. A face owns
    a direction whose component along its axis is the largest; a face with
    a count above 0 was live in that pass."""
    from kinfu_tpu_torch.ops.facewarp import face_frames

    R, t = cam2vol
    dev = weight.device
    frames = face_frames()
    axes = torch.as_tensor(np.stack([f.D[2] for f in frames]), dtype=torch.float32, device=dev)
    vs = torch.as_tensor(params.voxel_size, dtype=torch.float32, device=dev)
    zyx = torch.nonzero(weight > 0)
    owner_v = ((zyx.flip(-1).float() * vs - t) @ axes.T).argmax(-1)
    v, u = torch.meshgrid(torch.arange(intr.height, device=dev, dtype=torch.float32),
                          torch.arange(intr.width, device=dev, dtype=torch.float32),
                          indexing="ij")
    d_cam = torch.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                         torch.ones_like(u)], dim=-1)
    owner_p = ((d_cam @ R.T) @ axes.T).argmax(-1)[(normal != 0).any(-1)]
    vox = torch.bincount(owner_v, minlength=len(frames)).tolist()
    pix = torch.bincount(owner_p, minlength=len(frames)).tolist()
    return {f.name: (vox[k], pix[k]) for k, f in enumerate(frames)}


def raycasts(vol, cam2vol, intr, params):
    """(sweep maps, march maps): `raycast_warped` with its face flags and
    the "step" raycast, each (vertex, normal) as numpy arrays."""
    from kinfu_tpu_torch.ops.face_raycast import raycast_warped
    from kinfu_tpu_torch.volume.raycast import raycast

    warped = raycast_warped(vol, cam2vol, intr, params)
    march = raycast(vol, cam2vol, intr, params.replace(raycast_mode="step"))
    return (tuple(a.cpu().numpy() for a in warped), tuple(a.cpu().numpy() for a in march))


def fused_view(params, intr, device):
    """(volume, cam2vol): one frame of the orbit's scene at the identity
    pose fused into a fresh volume by the `integrate` dispatcher."""
    from kinfu_tpu_torch.data.synthetic import default_test_scene
    from kinfu_tpu_torch.geometry.se3 import compose, identity_pose, inverse, pose_from_matrix
    from kinfu_tpu_torch.volume.integrate import integrate
    from kinfu_tpu_torch.volume.tsdf import create_volume

    depth, color = default_test_scene().render_frame(np.eye(4, dtype=np.float32), intr)
    depth_m = torch.as_tensor(depth * np.float32(params.depth_scale), device=device)
    vol_pose = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    cam = identity_pose(device)
    vol = create_volume(params.volume_dims, device=device)
    integrate(vol, depth_m, torch.as_tensor(color, device=device), compose(inverse(cam), vol_pose),
              intr, params)
    return vol, compose(inverse(vol_pose), cam)


def probe(params, intr, device) -> dict:
    """The parity numbers of `params` and `intr` on `device`."""
    vol, cam2vol = fused_view(params, intr, device)
    (vm_w, nm_w), (vm_r, nm_r) = raycasts(vol, cam2vol, intr, params)
    return {"dim": params.volume_dims[0], **parity_stats(vm_w, nm_w, vm_r, nm_r)}


def main(argv=None) -> None:
    from kinfu_tpu_torch.config import KinFuParams
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("raycast_parity_probe: CUDA is not available (pass --device cpu)")
    import kinfu_tpu_torch  # noqa: F401  (full-f32 matmuls)

    f = 525.0 * args.width / 640
    intr = Intrinsics(width=args.width, height=args.height, fx=f, fy=f,
                      cx=args.width / 2 - 0.5, cy=args.height / 2 - 0.5)
    print(json.dumps(probe(KinFuParams(volume_dims=(args.dim,) * 3), intr, device)))


if __name__ == "__main__":
    main()
