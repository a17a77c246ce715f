"""Trajectory IO: the reader of the reference's poses.txt format (numpy-only
copy of kinfu_tpu/io/poses.py:34-44). Each pose is a cv::Matx44f block,
``[r00, r01, r02, t0;\n ... ;\n 0, 0, 0, 1]``.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np


def read_poses_reference_format(path: str) -> List[np.ndarray]:
    """Parse poses.txt-style dumps into 4x4 float32 matrices."""
    with open(path) as f:
        text = f.read()
    blocks = re.findall(r"\[(.*?)\]", text, flags=re.S)
    poses = []
    for b in blocks:
        vals = [float(v) for v in re.split(r"[,;\s]+", b.strip()) if v]
        if len(vals) == 16:
            poses.append(np.array(vals, dtype=np.float32).reshape(4, 4))
    return poses
