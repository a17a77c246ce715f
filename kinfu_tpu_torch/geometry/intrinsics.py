"""Pinhole intrinsics with pyramid-level scaling (port of
kinfu_tpu/geometry/intrinsics.py).

Half-pixel pyramid convention of the reference: ``c' = (c + 0.5) * 0.5^l
- 0.5`` with ``w' = w >> l``.
"""

from __future__ import annotations

import dataclasses

import torch

from kinfu_tpu_torch.numerics import recip


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    #: depth scale from a dataset's intr.txt; informational
    depth_scale: float = 1.0

    def level(self, level: int) -> "Intrinsics":
        if level == 0:
            return self
        s = 0.5**level
        return Intrinsics(
            width=self.width >> level,
            height=self.height >> level,
            fx=self.fx * s,
            fy=self.fy * s,
            cx=(self.cx + 0.5) * s - 0.5,
            cy=(self.cy + 0.5) * s - 0.5,
            depth_scale=self.depth_scale,
        )

    def pixel_rays(self, device="cpu") -> torch.Tensor:
        """[H, W, 3] unit-depth back-projected ray directions (camera frame)."""
        v = torch.arange(self.height, dtype=torch.float32, device=device)[:, None]
        u = torch.arange(self.width, dtype=torch.float32, device=device)[None, :]
        x = ((u - self.cx) * recip(self.fx)).expand(self.height, self.width)
        y = ((v - self.cy) * recip(self.fy)).expand(self.height, self.width)
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)
