"""Loader for the reference's bundled dataset layout (numpy-only copy of
kinfu_tpu/data/bundled.py, on the port's PNG reader and Intrinsics).

Layout (depth_sensor.cpp:13-46): a folder containing ``color/*.png``,
``depth/*.png`` (16-bit, millimetres) and ``intr.txt`` with five positive
values ``fx cx fy cy c`` (any separators; values <= 0.1 are skipped, matching
the reference parser). Image size comes from the first color frame.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator, Tuple

import numpy as np

from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.io.images import read_color_png, read_depth_png


class BundledDataset:
    def __init__(self, path: str):
        self.path = path
        self.color_files = sorted(glob.glob(os.path.join(path, "color", "*.png")))
        self.depth_files = sorted(glob.glob(os.path.join(path, "depth", "*.png")))
        if not self.color_files or not self.depth_files:
            raise FileNotFoundError(f"no camera! (no frames under {path})")
        self.intrinsics = self._read_intr(os.path.join(path, "intr.txt"))

    def _read_intr(self, intr_path: str) -> Intrinsics:
        with open(intr_path) as f:
            text = f.read()
        vals = [float(v) for v in re.split(r"[\s,;]+", text.strip()) if v]
        vals = [v for v in vals if v > 0.1][:5]
        if len(vals) != 5:
            raise ValueError(f"intr.txt must contain 5 values, got {vals}")
        fx, cx, fy, cy, c = vals
        first = read_color_png(self.color_files[0])
        h, w = first.shape[:2]
        # the 5th value is depth units per metre (1000 for mm, like TUM's
        # 5000) — the reference's > 0.1 parser filter implies the divisor
        # convention (a metres-per-unit scale like 0.001 would be dropped).
        # The reference parses it then ignores it, hardcoding 0.001
        # (image_process.cu:14); here it feeds KinFuParams.depth_scale.
        return Intrinsics(
            width=w, height=h, fx=fx, fy=fy, cx=cx, cy=cy, depth_scale=1.0 / c
        )

    def __len__(self) -> int:
        return min(len(self.color_files), len(self.depth_files))

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(color u8 [H,W,3] RGB, depth f32 [H,W] raw sensor units)."""
        color = read_color_png(self.color_files[i])
        depth = read_depth_png(self.depth_files[i]).astype(np.float32)
        return color, depth

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]
