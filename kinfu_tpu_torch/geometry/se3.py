"""SE(3) utilities on tensors (port of kinfu_tpu/geometry/se3.py).

A pose is the rigid transform ``p' = R @ p + t`` stored as (R, t). The ICP
increment is ``cv::Affine3f(rvec, tvec)``: R = Rodrigues(rvec) and the
translation is tvec directly (not the SE(3) exponential map).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from kinfu_tpu_torch.device import constant
from kinfu_tpu_torch.numerics import recip


class Pose(NamedTuple):
    """Rigid transform p' = R @ p + t."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]


def identity_pose(device="cpu") -> Pose:
    return Pose(
        torch.eye(3, dtype=torch.float32, device=device),
        torch.zeros(3, dtype=torch.float32, device=device),
    )


def pose_from_matrix(T: torch.Tensor) -> Pose:
    return Pose(T[..., :3, :3], T[..., :3, 3])


@functools.lru_cache(maxsize=None)
def _bottom_row(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return constant([0.0, 0.0, 0.0, 1.0], dtype, device)


def pose_matrix(p: Pose) -> torch.Tensor:
    """4x4 homogeneous matrix."""
    R, t = p
    bottom = _bottom_row(R.dtype, R.device).expand(R.shape[:-2] + (1, 4))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R @ v[..., :, None])[..., 0]


def compose(a: Pose, b: Pose) -> Pose:
    """a * b: apply b first, then a."""
    return Pose(a.R @ b.R, _matvec(a.R, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -_matvec(Rt, p.t))


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points of shape [..., 3]."""
    return pts @ p.R.T + p.t


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from an axis-angle 3-vector (cv::Rodrigues), with
    the series forms of sin(t)/t and (1-cos(t))/t^2 near 0."""
    theta2 = (rvec * rvec).sum(-1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    one = torch.ones_like(theta2)
    a = torch.where(small, 1.0 - theta2 * recip(6.0),
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 * recip(24.0),
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    wx, wy, wz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def se3_increment(x: torch.Tensor) -> Pose:
    """ICP pose increment from the 6-vector solve result: Rodrigues(x[:3])
    and the translation x[3:6] used directly (icp_registration.cpp:41)."""
    return Pose(rodrigues(x[..., 0:3]).float(), x[..., 3:6].float())


def rotvec_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Axis-angle 3-vector from a rotation matrix (log map, rotation only).

    Safe to differentiate at the identity, where arccos((tr-1)/2) has an
    infinite derivative: theta comes from atan2 on guarded inputs and the
    small-angle branch is a polynomial, so neither branch yields a NaN
    (the pose graph differentiates through this). Angles near pi are
    outside the accurate range (the antisymmetric part vanishes there)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    # antisymmetric part: w = 2 sin(theta) * axis
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    n2 = (w * w).sum(-1)  # = 4 sin^2(theta)
    small = n2 < 1e-12
    n2_safe = torch.where(small, torch.ones_like(n2), n2)
    sin_t = torch.sqrt(n2_safe) * 0.5
    theta = torch.atan2(sin_t, cos_t)
    # theta / (2 sin theta) ~= 0.5 + theta^2/12, theta^2 ~= n2/4 when small
    scale = torch.where(small, 0.5 + n2 * recip(48.0), theta / (2.0 * sin_t))
    return w * scale[..., None]
