"""Trajectory IO (numpy-only copy of kinfu_tpu/io/poses.py).

Two formats:
  - the reference's poses.txt: each pose a cv::Matx44f block,
    ``[r00, r01, r02, t0;\n ... ;\n 0, 0, 0, 1]``, values as ``%.8g``
    (main.cpp:95-98; doc/poses.txt holds ground-truth examples);
  - TUM RGB-D: ``timestamp tx ty tz qx qy qz qw`` per line.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np


def write_poses_reference_format(path: str, poses: Sequence[np.ndarray]) -> None:
    with open(path, "w") as f:
        for T in poses:
            T = np.asarray(T, dtype=np.float32)
            rows = []
            for i in range(4):
                rows.append(", ".join(_fmt(v) for v in T[i]))
            f.write("[" + ";\n ".join(rows) + "]\n")


def _fmt(v: float) -> str:
    # cv::Mat prints floats with up to 8 significant digits
    return f"{float(v):.8g}"


def read_poses_reference_format(path: str) -> List[np.ndarray]:
    """Parse doc/poses.txt-style dumps (50 4x4 row-major matrices)."""
    with open(path) as f:
        text = f.read()
    blocks = re.findall(r"\[(.*?)\]", text, flags=re.S)
    poses = []
    for b in blocks:
        vals = [float(v) for v in re.split(r"[,;\s]+", b.strip()) if v]
        if len(vals) == 16:
            poses.append(np.array(vals, dtype=np.float32).reshape(4, 4))
    return poses


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def _matrix_from_quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def write_poses_tum(
    path: str, poses: Sequence[np.ndarray], timestamps: Sequence[float] | None = None
) -> None:
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            T = np.asarray(T, dtype=np.float64)
            ts = timestamps[i] if timestamps is not None else float(i)
            q = _quat_from_matrix(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_poses_tum(path: str) -> tuple[np.ndarray, List[np.ndarray]]:
    """Returns (timestamps [N], poses list of 4x4)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            T = np.eye(4)
            T[:3, 3] = vals[1:4]
            T[:3, :3] = _matrix_from_quat(np.array(vals[4:8]))
            poses.append(T.astype(np.float32))
    return np.array(ts), poses
