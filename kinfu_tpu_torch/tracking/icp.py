"""Frame-to-model projective point-to-plane ICP (port of
kinfu_tpu/tracking/icp.py, "gather" mode).

The whole coarse-to-fine optimisation stays on the device: the 6x6 solve
uses `torch.linalg.solve_ex` (plain `solve` checks for a singular matrix
and so waits for the device), and every result is picked with
`torch.where` on device tensors, never with a host read.

The warped ICP kernel (kinfu_tpu/ops/pallas_icp.py, K1) is not ported
yet: `icp_mode="warped"` raises; "auto" resolves to "gather", as the JAX
package does off the TPU (kinfu_tpu/tracking/icp.py:139-140).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, compose, identity_pose, se3_increment
from kinfu_tpu_torch.numerics import rint_index


class ICPResult(NamedTuple):
    #: previous-camera-from-current-camera increment
    pose: Pose
    #: False when any 6x6 system was singular (tracking failure)
    ok: torch.Tensor
    #: inlier correspondence count of the last iteration (finest level)
    num_inliers: torch.Tensor


def resolve_icp_mode(params: KinFuParams) -> str:
    mode = "gather" if params.icp_mode == "auto" else params.icp_mode
    if mode == "warped":
        raise NotImplementedError(
            "icp_mode='warped' needs the ICP kernel K1 "
            "(kinfu_tpu/ops/pallas_icp.py), which is not ported yet: "
            "ROADMAP.md queue 2, K1. Use icp_mode='gather' or 'auto'."
        )
    return mode


def _normal_equations(
    inc: Pose,
    cur_vmap: torch.Tensor,
    cur_nmap: torch.Tensor,
    pre_vmap: torch.Tensor,
    pre_nmap: torch.Tensor,
    intr: Intrinsics,
    dist_thres: float,
    sin_angle_thres: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(A [6,6], b [6], inlier_count) for one Gauss-Newton iteration
    (kinfu_tpu/tracking/icp.py:47-117)."""
    h, w, _ = pre_vmap.shape
    R, t = inc

    ncur_valid = (cur_nmap != 0).any(dim=-1)

    s = cur_vmap @ R.T + t
    z = s[..., 2]
    zsafe = torch.where(z > 0, z, torch.ones_like(z))
    u = rint_index(s[..., 0] / zsafe * intr.fx + intr.cx)
    v = rint_index(s[..., 1] / zsafe * intr.fy + intr.cy)
    inb = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)

    lin = torch.clamp(v * w + u, 0, h * w - 1)
    d = pre_vmap.reshape(-1, 3)[lin]
    n = pre_nmap.reshape(-1, 3)[lin]

    dist = torch.linalg.vector_norm(s - d, dim=-1)
    ncur_t = cur_nmap @ R.T
    sine = torch.linalg.vector_norm(torch.linalg.cross(ncur_t, n, dim=-1), dim=-1)
    npre_valid = (n != 0).any(dim=-1)

    mask = ncur_valid & inb & npre_valid & (dist <= dist_thres) & (sine <= sin_angle_thres)

    c = torch.linalg.cross(s, n, dim=-1)
    r = (n * (d - s)).sum(dim=-1)
    rows = torch.cat([c, n, r[..., None]], dim=-1)
    rows = torch.where(mask[..., None], rows, torch.zeros_like(rows)).reshape(-1, 7)

    G = rows.T @ rows
    ninl = mask.sum().to(torch.int32)
    return G[:6, :6], G[:6, 6], ninl


def rigid_icp(
    cur_vmaps: Sequence[torch.Tensor],
    cur_nmaps: Sequence[torch.Tensor],
    pre_vmaps: Sequence[torch.Tensor],
    pre_nmaps: Sequence[torch.Tensor],
    intr: Intrinsics,
    params: KinFuParams,
) -> ICPResult:
    """Coarse-to-fine ICP; returns the prev<-cur camera increment."""
    resolve_icp_mode(params)
    device = cur_vmaps[0].device
    sin_thres = math.sin(math.radians(params.icp_angle_threshold))
    eye6 = torch.eye(6, dtype=torch.float32, device=device)
    pose = identity_pose(device)
    ok = torch.ones((), dtype=torch.bool, device=device)
    inliers = torch.zeros((), dtype=torch.int32, device=device)

    for level, iters in params.level_iters_coarse_to_fine():
        lintr = intr.level(level)
        cv, cn = cur_vmaps[level], cur_nmaps[level]
        pv, pn = pre_vmaps[level], pre_nmaps[level]
        for _ in range(iters):
            A, b, inliers = _normal_equations(
                pose, cv, cn, pv, pn, lintr, params.icp_dist_threshold, sin_thres
            )
            det = torch.linalg.det(A)
            good = (det.abs() >= 1e-15) & ~torch.isnan(det)
            x, _ = torch.linalg.solve_ex(torch.where(good, A, eye6), b)
            x = torch.where(good, x, torch.zeros_like(x))
            new_pose = compose(pose, se3_increment(x))
            keep = ok & good
            pose = Pose(
                torch.where(keep, new_pose.R, pose.R),
                torch.where(keep, new_pose.t, pose.t),
            )
            ok = keep

    return ICPResult(pose=pose, ok=ok, num_inliers=inliers)
