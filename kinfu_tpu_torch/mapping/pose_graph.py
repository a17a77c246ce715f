"""Pose-graph optimization over keyframe poses (port of
kinfu_tpu/mapping/pose_graph.py).

No reference equivalent: the reference keeps every pose in an unbounded
vector with no drift correction (kinectfusion.h:59).

Model: nodes are world-from-keyframe poses; an edge (i, j, Z_ij) constrains
the relative pose with measurement Z_ij ~ T_i^-1 T_j. The residual is the
right-invariant error r_ij = log(Z_ij^-1 (T_i^-1 T_j)) in R^6
(rotation-vector ++ translation). Gauss-Newton with node 0 held fixed; the
Jacobian is `torch.func.jacfwd` over per-node local increments
(T_k <- T_k * Exp(dx_k)), and the normal equations are solved densely with
`torch.linalg.solve`, in float32 (the package disables TF32), on the
device the caller names.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.device import resolve_device
from kinfu_tpu_torch.geometry.se3 import rodrigues, rotvec_from_matrix


class PoseGraphEdge(NamedTuple):
    i: int
    j: int
    #: measured T_i^-1 T_j, [4,4]
    z: np.ndarray
    #: scalar information weight (rotation block also scaled by this)
    weight: float = 1.0


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[...,3,3], [...,3] -> [...,4,4]."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., :, None]], dim=-1), bottom], dim=-2)


def _exp6(x: torch.Tensor) -> torch.Tensor:
    """[...,6] (rotvec ++ t) -> [...,4,4]; the cv::Affine increment
    convention of se3.py::se3_increment."""
    return _homogeneous(rodrigues(x[..., :3]), x[..., 3:])


def _log6(T: torch.Tensor) -> torch.Tensor:
    """[...,4,4] -> [...,6], the inverse of _exp6."""
    return torch.cat([rotvec_from_matrix(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def _residuals(dx, poses, ii, jj, zinv, w) -> torch.Tensor:
    """Stacked weighted residuals [E, 6] at local increments dx [N, 6]."""
    T = poses @ _exp6(dx)
    Ti = T[ii]
    Tj = T[jj]
    # T_i^-1 T_j without forming inverses explicitly
    Ri = Ti[..., :3, :3].transpose(-1, -2)
    rel_R = Ri @ Tj[..., :3, :3]
    rel_t = (Ri @ (Tj[..., :3, 3] - Ti[..., :3, 3])[..., None])[..., 0]
    r = _log6(zinv @ _homogeneous(rel_R, rel_t))
    return r * w[:, None]


def optimize_pose_graph(
    poses: Sequence[np.ndarray],
    edges: Sequence[PoseGraphEdge],
    iterations: int = 10,
    damping: float = 1e-6,
    device="cuda",
) -> Tuple[List[np.ndarray], float]:
    """Gauss-Newton pose-graph optimization on `device` (the card unless
    the caller asks for the CPU). Node 0 is held fixed (gauge). Returns
    (optimized poses, final RMS residual). The convergence test reads the
    device once an iteration, outside any per-frame step."""
    N = len(poses)
    if N == 0:
        return [], 0.0
    dev = resolve_device(device)
    f32 = torch.float32
    P = torch.as_tensor(np.stack([np.asarray(p, np.float32) for p in poses]), device=dev)
    ii = torch.as_tensor([e.i for e in edges], dtype=torch.int64, device=dev)
    jj = torch.as_tensor([e.j for e in edges], dtype=torch.int64, device=dev)
    zinv = torch.as_tensor(
        np.stack([np.linalg.inv(np.asarray(e.z, np.float64)).astype(np.float32)
                  for e in edges]), device=dev)
    w = torch.as_tensor(np.array([np.sqrt(e.weight) for e in edges], np.float32), device=dev)

    def res_flat(dx, P):
        return _residuals(dx, P, ii, jj, zinv, w).reshape(-1)

    jac_fn = torch.func.jacfwd(res_flat)
    zero = torch.zeros((N, 6), dtype=f32, device=dev)
    eye = torch.eye(6 * (N - 1), dtype=f32, device=dev)
    for _ in range(iterations):
        r = res_flat(zero, P)
        J = jac_fn(zero, P).reshape(-1, N * 6)
        # gauge: drop node 0's columns
        Jf = J[:, 6:]
        H = Jf.T @ Jf + damping * eye
        g = Jf.T @ r
        dx = torch.linalg.solve(H, -g)
        dx_full = torch.cat([torch.zeros(6, dtype=f32, device=dev), dx]).reshape(N, 6)
        P = P @ _exp6(dx_full)
        if float(dx.abs().max()) < 1e-9:
            break
    r = res_flat(zero, P)
    rms = float(torch.sqrt(torch.mean(r * r)))
    Pn = P.cpu().numpy()
    return [Pn[k] for k in range(N)], rms


def odometry_edges(poses: Sequence[np.ndarray], weight: float = 1.0) -> List[PoseGraphEdge]:
    """Consecutive-pose edges from a tracked trajectory."""
    out = []
    for k in range(len(poses) - 1):
        z = np.linalg.inv(np.asarray(poses[k], np.float64)) @ np.asarray(
            poses[k + 1], np.float64
        )
        out.append(PoseGraphEdge(k, k + 1, z.astype(np.float32), weight))
    return out
