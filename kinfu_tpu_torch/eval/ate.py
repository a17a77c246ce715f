"""Trajectory accuracy metrics: ATE and RPE (numpy-only copy of
kinfu_tpu/eval/ate.py).

The reference publishes no accuracy numbers and ships no evaluation code
(SURVEY.md section 6); these are the standard TUM RGB-D benchmark metrics
(Sturm et al., IROS 2012) used for the BASELINE.md targets.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _translations(poses: Sequence[np.ndarray]) -> np.ndarray:
    return np.stack([np.asarray(T)[:3, 3] for T in poses], axis=0)


def align_umeyama(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/rigid alignment est -> gt.

    Returns (R, t, s) minimising ||gt - (s R est + t)||.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe**2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    align: bool = True,
) -> float:
    """Absolute trajectory error RMSE (metres) after rigid alignment."""
    est = _translations(est_poses)
    gt = _translations(gt_poses)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        R, t, s = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rpe_rmse(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error RMSE over a fixed frame delta.

    Returns (translational RMSE in metres, rotational RMSE in radians).
    """
    n = min(len(est_poses), len(gt_poses))
    terrs, rerrs = [], []
    for i in range(n - delta):
        Ee = np.linalg.inv(np.asarray(est_poses[i], dtype=np.float64)) @ np.asarray(
            est_poses[i + delta], dtype=np.float64
        )
        Eg = np.linalg.inv(np.asarray(gt_poses[i], dtype=np.float64)) @ np.asarray(
            gt_poses[i + delta], dtype=np.float64
        )
        E = np.linalg.inv(Eg) @ Ee
        terrs.append(np.linalg.norm(E[:3, 3]))
        angle = np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1))
        rerrs.append(angle)
    return float(np.sqrt(np.mean(np.array(terrs) ** 2))), float(
        np.sqrt(np.mean(np.array(rerrs) ** 2))
    )
