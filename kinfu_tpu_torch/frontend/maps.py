"""Vertex/normal maps and model-pyramid downsampling (port of
kinfu_tpu/frontend/maps.py). Invalid entries are exact zeros.
"""

from __future__ import annotations

from typing import List

import torch

from kinfu_tpu_torch.frontend.depth import bilateral_filter, pyr_down, scale_and_truncate
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.numerics import recip


def vertex_map(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Back-project a depth map to camera-frame points [H, W, 3]."""
    h, w = depth.shape
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    x = depth * (u - intr.cx) * recip(intr.fx)
    y = depth * (v - intr.cy) * recip(intr.fy)
    return torch.stack([x, y, depth], dim=-1)


def normal_map(vmap: torch.Tensor, disc_threshold: float = 0.1) -> torch.Tensor:
    """Normals from central differences of the vertex map, flipped so
    n.z <= 0; zero where a 4-neighbour is invalid, across a depth
    discontinuity, or on the image border.

    Neighbours come from `torch.roll`, as the JAX package takes them from
    `jnp.roll` (kinfu_tpu/frontend/maps.py:45-54): the wrapped border
    rows/cols give the same values there, and the border mask below zeroes
    them in both."""
    h, w, _ = vmap.shape
    left = torch.roll(vmap, 1, dims=1)
    right = torch.roll(vmap, -1, dims=1)
    up = torch.roll(vmap, 1, dims=0)
    down = torch.roll(vmap, -1, dims=0)

    n = torch.linalg.cross(left - right, up - down, dim=-1)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)

    z = vmap[..., 2]
    tau = disc_threshold * z
    valid = (
        ((left[..., 2] - z).abs() < tau)
        & ((right[..., 2] - z).abs() < tau)
        & ((up[..., 2] - z).abs() < tau)
        & ((down[..., 2] - z).abs() < tau)
        & (left[..., 2] != 0)
        & (right[..., 2] != 0)
        & (up[..., 2] != 0)
        & (down[..., 2] != 0)
        & (norm[..., 0] > 0)
    )
    yy = torch.arange(h, device=vmap.device)[:, None]
    xx = torch.arange(w, device=vmap.device)[None, :]
    valid = valid & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)

    n = n / torch.clamp(norm, min=1e-30)
    return torch.where(valid[..., None], n, torch.zeros_like(n))


def resize_points_normals(
    vmap: torch.Tensor, nmap: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2 downsample of the raycast model maps for coarser ICP levels:
    mean over valid entries only, normals renormalised, empty blocks zero
    (the JAX package's deliberate divergence from the reference)."""

    def block(m: torch.Tensor) -> torch.Tensor:
        h, w, c = m.shape
        return m.reshape(h // 2, 2, w // 2, 2, c)

    vblk = block(vmap)
    nblk = block(nmap)
    nvalid = (nblk != 0).any(dim=-1, keepdim=True)
    vvalid = vblk[..., 2:3] != 0

    def masked_mean(blk, valid):
        cnt = valid.sum(dim=(1, 3))
        s = (blk * valid).sum(dim=(1, 3))
        return s / torch.clamp(cnt, min=1) * (cnt > 0)

    v = masked_mean(vblk, vvalid)
    n = masked_mean(nblk, nvalid)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-30) * (norm > 1e-20)
    return v, n


def build_measurement_pyramid(
    depth_mm: torch.Tensor,
    intr: Intrinsics,
    *,
    pyramid_height: int,
    bfilter_kernel_size: int,
    bfilter_color_sigma: float,
    bfilter_spatial_sigma: float,
    depth_scale: float,
    max_dist: float,
    normal_disc_threshold: float = 0.1,
) -> tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Depth/vertex/normal pyramids, level 0 finest; depths in metres.

    pyrDown on raw-mm depth, then bilateral per level, then scale+clip,
    then vertex/normal (kinectfusion.cpp:48-76)."""
    raw = [depth_mm]
    for _ in range(1, pyramid_height):
        raw.append(pyr_down(raw[-1]))

    dmaps, vmaps, nmaps = [], [], []
    for level in range(pyramid_height):
        d = bilateral_filter(
            raw[level],
            kernel_size=bfilter_kernel_size,
            sigma_color=bfilter_color_sigma,
            sigma_spatial=bfilter_spatial_sigma,
        )
        d = scale_and_truncate(d, depth_scale, max_dist)
        vm = vertex_map(d, intr.level(level))
        # the central-difference baseline doubles per level
        nm = normal_map(vm, disc_threshold=normal_disc_threshold * (2.0**level))
        dmaps.append(d)
        vmaps.append(vm)
        nmaps.append(nm)
    return dmaps, vmaps, nmaps
