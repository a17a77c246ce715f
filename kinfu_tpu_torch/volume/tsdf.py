"""TSDF volume state (port of kinfu_tpu/volume/tsdf.py).

Layout [Z, Y, X], X innermost. Voxel storage as in the reference's 8-byte
voxel: TSDF int16 fixed point scaled by 32767 and truncated toward zero,
weight int16 clamped to max_weight, colour packed 0x00RRGGBB in int32.

The port updates the volume in place (the fusion kernel writes into the
tensors it is given); JAX gets the same effect from buffer donation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from kinfu_tpu_torch.device import resolve_device

SHORTMAX = 32767.0


class TSDFVolume(NamedTuple):
    """Dense TSDF state. All tensors are [Z, Y, X]."""

    tsdf: torch.Tensor  # int16, fixed-point distance / trunc in [-1, 1]
    weight: torch.Tensor  # int16
    color: torch.Tensor  # int32, packed 0x00RRGGBB (always >= 0)


def create_volume(dims_xyz: Tuple[int, int, int], device="cuda") -> TSDFVolume:
    """Allocate a zeroed volume on `device`; dims given as (X, Y, Z) like
    the config. "cuda" without a usable CUDA device raises."""
    device = resolve_device(device)
    x, y, z = dims_xyz
    shape = (z, y, x)
    return TSDFVolume(
        tsdf=torch.zeros(shape, dtype=torch.int16, device=device),
        weight=torch.zeros(shape, dtype=torch.int16, device=device),
        color=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def reset_volume(vol: TSDFVolume) -> TSDFVolume:
    """Zero all fields in place (device::resetVolume)."""
    for a in vol:
        a.zero_()
    return vol


def reset_failed_(vol: TSDFVolume, good: torch.Tensor) -> TSDFVolume:
    """Zero all fields in place where the device bool `good` is False (a
    failed frame's reset, kinectfusion.cpp:97-102): a multiply by the flag,
    so nothing waits for the device."""
    for a in vol:
        a.mul_(good.to(a.dtype))
    return vol


def tsdf_to_float(fixed: torch.Tensor) -> torch.Tensor:
    """int16 fixed-point -> float32 in [-1, 1]."""
    return fixed.float() * (1.0 / SHORTMAX)


def tsdf_to_fixed(value: torch.Tensor) -> torch.Tensor:
    """float32 -> int16 fixed-point, truncating toward zero."""
    scaled = torch.clamp(value * SHORTMAX, -SHORTMAX, SHORTMAX)
    return torch.trunc(scaled).to(torch.int16)


def pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [...] int32 packed 0x00RRGGBB."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    return (r << 16) | (g << 8) | b


def unpack_rgb(packed: torch.Tensor) -> torch.Tensor:
    """[...] packed int -> [..., 3] float32 channels in [0, 255]."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).float()
