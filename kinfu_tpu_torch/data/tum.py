"""TUM RGB-D dataset loader (fr1/fr2/fr3 sequences; numpy-only copy of
kinfu_tpu/data/tum.py, on the port's PNG reader, pose reader and Intrinsics).

Layout: ``rgb.txt`` / ``depth.txt`` association lists (timestamp filename),
``groundtruth.txt`` in TUM trajectory format, 16-bit depth PNGs scaled by
1/5000 m. Associates color/depth/gt by nearest timestamp (max 20 ms), the
standard TUM tooling behaviour. No reference equivalent (the reference only
reads its bundled folder); needed for the ATE benchmarks in BASELINE.md.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.io.images import read_color_png, read_depth_png
from kinfu_tpu_torch.io.poses import read_poses_tum

# Default ROS-calibration intrinsics for freiburg1 sequences
FR1_INTRINSICS = Intrinsics(
    width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3, depth_scale=1 / 5000
)
FR2_INTRINSICS = Intrinsics(
    width=640, height=480, fx=520.9, fy=521.0, cx=325.1, cy=249.7, depth_scale=1 / 5000
)


def _read_file_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate(
    a: List[Tuple[float, str]], b: List[Tuple[float, str]], max_dt: float = 0.02
) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py behaviour)."""
    pairs = []
    used = set()
    for i, (ta, _) in enumerate(a):
        best, best_dt = None, max_dt
        for j in range(len(b)):
            if j in used:
                continue
            dt = abs(b[j][0] - ta)
            if dt < best_dt:
                best, best_dt = j, dt
        if best is not None:
            used.add(best)
            pairs.append((i, best))
    return pairs


class TUMDataset:
    def __init__(self, path: str, intrinsics: Optional[Intrinsics] = None):
        self.path = path
        rgb = _read_file_list(os.path.join(path, "rgb.txt"))
        depth = _read_file_list(os.path.join(path, "depth.txt"))
        self.pairs = [
            (rgb[i][0], rgb[i][1], depth[j][1]) for i, j in associate(rgb, depth)
        ]
        if not self.pairs:
            raise FileNotFoundError(f"no associated frames under {path}")
        name = os.path.basename(os.path.normpath(path))
        if intrinsics is None:
            intrinsics = FR2_INTRINSICS if "freiburg2" in name else FR1_INTRINSICS
        self.intrinsics = intrinsics
        gt_path = os.path.join(path, "groundtruth.txt")
        self.gt_timestamps, self.gt_poses = (
            read_poses_tum(gt_path) if os.path.exists(gt_path) else (np.array([]), [])
        )

    def __len__(self) -> int:
        return len(self.pairs)

    def timestamp(self, i: int) -> float:
        return self.pairs[i][0]

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(color u8 RGB, depth f32 raw 1/5000 m units -> use depth_scale)."""
        ts, rgb_f, depth_f = self.pairs[i]
        color = read_color_png(os.path.join(self.path, rgb_f))
        depth = read_depth_png(os.path.join(self.path, depth_f)).astype(np.float32)
        return color, depth

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]
