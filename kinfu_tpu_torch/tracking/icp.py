"""Frame-to-model projective point-to-plane ICP (port of
kinfu_tpu/tracking/icp.py).

The whole coarse-to-fine optimisation stays on the device, and every
result is picked on device tensors, never with a host read.

Each iteration's normal equations come from one of two paths:
  - "warped": K1 (`ops/icp_warped.py`). On a CUDA tensor the whole ICP is
    one host call, `icp_solve_warped`: K1's finishing form solves each
    iteration's system and updates the pose on the card, launched once per
    iteration from C. On a CPU tensor each iteration is K1's plain version
    and `finish_iteration`.
  - "gather": `_normal_equations` below and `finish_iteration`, plain
    PyTorch on any device (the 6x6 solve is `torch.linalg.solve_ex`; plain
    `solve` checks for a singular matrix and so waits for the device).
"auto" resolves to "warped" on a CUDA device and to "gather" on the CPU,
as the JAX package picks the warped kernel on its accelerator and the
gather path on the CPU (kinfu_tpu/tracking/icp.py:139-140).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, compose, identity_pose, se3_increment
from kinfu_tpu_torch.numerics import rint_index
from kinfu_tpu_torch.ops.icp_warped import (
    icp_normal_eqs_warped,
    icp_normal_eqs_warped_plain,
    icp_solve_warped,
    unpack_state,
)


class ICPResult(NamedTuple):
    #: previous-camera-from-current-camera increment
    pose: Pose
    #: False when any 6x6 system was singular (tracking failure)
    ok: torch.Tensor
    #: inlier correspondence count of the last iteration (finest level)
    num_inliers: torch.Tensor


def resolve_icp_mode(params: KinFuParams, device) -> str:
    """"warped" or "gather": an explicit mode as it is; "auto" is "warped"
    on a CUDA device and "gather" elsewhere."""
    if params.icp_mode != "auto":
        return params.icp_mode
    return "warped" if torch.device(device).type == "cuda" else "gather"


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


def finish_iteration(A: torch.Tensor, b: torch.Tensor, inliers: torch.Tensor, pose: Pose,
                     ok: torch.Tensor) -> Tuple[Pose, torch.Tensor, torch.Tensor]:
    """The end of one Gauss-Newton iteration (kinfu_tpu/tracking/icp.py:
    188-199): solve A x = b unless A is singular (|det| < 1e-15 or NaN, a
    tracking failure), apply the increment Rodrigues(x[:3]), x[3:] to
    `pose`, and keep it only while every system so far was solvable.
    Returns (pose, ok, inliers). K1's finishing form computes the same on
    the card."""
    det = torch.linalg.det(A)
    good = (det.abs() >= 1e-15) & ~torch.isnan(det)
    eye6 = torch.eye(6, dtype=torch.float32, device=A.device)
    x, _ = torch.linalg.solve_ex(torch.where(good, A, eye6), b)
    x = torch.where(good, x, torch.zeros_like(x))
    new_pose = compose(pose, se3_increment(x))
    keep = ok & good
    pose = Pose(
        torch.where(keep, new_pose.R, pose.R),
        torch.where(keep, new_pose.t, pose.t),
    )
    return pose, keep, inliers


NormalEquations = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def icp_loop(
    cur_vmaps: Sequence[torch.Tensor],
    cur_nmaps: Sequence[torch.Tensor],
    pre_vmaps: Sequence[torch.Tensor],
    pre_nmaps: Sequence[torch.Tensor],
    intr: Intrinsics,
    params: KinFuParams,
    normal_equations: NormalEquations,
) -> ICPResult:
    """Coarse-to-fine ICP with one host call per iteration: each
    iteration's system from `normal_equations`, then `finish_iteration`."""
    device = cur_vmaps[0].device
    sin_thres = math.sin(math.radians(params.icp_angle_threshold))
    pose = identity_pose(device)
    ok = torch.ones((), dtype=torch.bool, device=device)
    inliers = torch.zeros((), dtype=torch.int32, device=device)

    for level, iters in params.level_iters_coarse_to_fine():
        lintr = intr.level(level)
        cv, cn = cur_vmaps[level], cur_nmaps[level]
        pv, pn = pre_vmaps[level], pre_nmaps[level]
        for _ in range(iters):
            A, b, ninl = normal_equations(
                pose, cv, cn, pv, pn, lintr, params.icp_dist_threshold, sin_thres
            )
            pose, ok, inliers = finish_iteration(A, b, ninl, pose, ok)

    return ICPResult(pose=pose, ok=ok, num_inliers=inliers)


def rigid_icp_plain(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr: Intrinsics,
                    params: KinFuParams) -> ICPResult:
    """Plain PyTorch version of the warped ICP on any device: K1's plain
    version and `finish_iteration` for every iteration."""
    return icp_loop(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr, params,
                    icp_normal_eqs_warped_plain)


def rigid_icp(
    cur_vmaps: Sequence[torch.Tensor],
    cur_nmaps: Sequence[torch.Tensor],
    pre_vmaps: Sequence[torch.Tensor],
    pre_nmaps: Sequence[torch.Tensor],
    intr: Intrinsics,
    params: KinFuParams,
) -> ICPResult:
    """Coarse-to-fine ICP; returns the prev<-cur camera increment. The
    normal equations take the path `resolve_icp_mode` picks; the warped
    path on a tensor that is not on the CPU is one launch of K1's finishing
    form per iteration, from one host call."""
    device = cur_vmaps[0].device
    if resolve_icp_mode(params, device) == "gather":
        return icp_loop(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr, params,
                        _normal_equations)
    levels = [(cur_vmaps[lv], cur_nmaps[lv], pre_vmaps[lv], pre_nmaps[lv], intr.level(lv), n)
              for lv, n in params.level_iters_coarse_to_fine() if n > 0]
    if device.type == "cpu" or not levels:
        return icp_loop(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr, params,
                        icp_normal_eqs_warped)
    sin_thres = math.sin(math.radians(params.icp_angle_threshold))
    pose, ok, inliers = unpack_state(
        icp_solve_warped(levels, params.icp_dist_threshold, sin_thres))
    return ICPResult(pose=pose, ok=ok, num_inliers=inliers)
