"""Depth-image preprocessing: pyramid downsample, bilateral filter, clip
(port of kinfu_tpu/frontend/depth.py). Plain PyTorch: both filters are
fixed 5x5 stencils written as sums of 25 shifted images, in the JAX
package's order. No TPU kernel lives here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# OpenCV pyrDown 5-tap Gaussian: outer product of [1, 4, 6, 4, 1] / 16.
_PYR_TAPS = (1.0, 4.0, 6.0, 4.0, 1.0)


def _reflect_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """Reflect-101 border, like jnp.pad(mode="reflect")."""
    return F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]


def pyr_down(depth: torch.Tensor) -> torch.Tensor:
    """Gaussian blur (reflect-101 border) + 2x decimation, like cv::pyrDown."""
    h, w = depth.shape
    padded = _reflect_pad(depth, 2)
    acc = torch.zeros_like(depth)
    for dy, wy in enumerate(_PYR_TAPS):
        for dx, wx in enumerate(_PYR_TAPS):
            acc = acc + (wy * wx) * padded[dy : dy + h, dx : dx + w]
    return (acc / 256.0)[::2, ::2]


def bilateral_filter(
    depth: torch.Tensor,
    kernel_size: int = 5,
    sigma_color: float = 10.0,
    sigma_spatial: float = 10.0,
) -> torch.Tensor:
    """Edge-preserving smoothing on raw depth (OpenCV weight convention)."""
    h, w = depth.shape
    r = kernel_size // 2
    padded = _reflect_pad(depth, r)
    inv2sc = -0.5 / (sigma_color * sigma_color)
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    for dy in range(kernel_size):
        for dx in range(kernel_size):
            sw = math.exp(((dy - r) ** 2 + (dx - r) ** 2) * -0.5 / (sigma_spatial**2))
            nb = padded[dy : dy + h, dx : dx + w]
            diff = nb - depth
            wgt = sw * torch.exp(diff * diff * inv2sc)
            num = num + wgt * nb
            den = den + wgt
    return num / torch.clamp(den, min=1e-20)


def scale_and_truncate(depth: torch.Tensor, scale: float, max_dist: float) -> torch.Tensor:
    """mm -> m and zero out beyond the far clip."""
    d = depth * scale
    return torch.where(d <= max_dist, d, torch.zeros_like(d))
