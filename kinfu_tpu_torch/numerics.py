"""Float32 rounding rules the port shares with the JAX package.

XLA's algebraic simplifier rewrites a division by a compile-time constant
into a multiplication by the constant's float32 reciprocal, so wherever the
JAX package divides by a static value (a focal length, a face focal, a
Python literal) it computes `x * float32(1 / c)`. The port multiplies by
`recip(c)` at exactly those places, and divides where the JAX package
divides by a traced value, so that the plain versions, the CUDA kernels
and the JAX package round alike and pick the same voxels and pixels.

`rint_index` rounds half to even (`jnp.rint`) to an int64 index, clamped
to +-2^24 first so that the cast is defined; any clamped value fails a
bounds test either way, as in the kernels' `rint_clamped`.

`sqrt32` is the correctly rounded float32 square root that XLA and CUDA's
`sqrtf` compute. PyTorch's vectorised CPU kernel can be an ulp off, which
is enough to move an int16 range or TSDF value across an integer.
"""

from __future__ import annotations

import numpy as np
import torch


def recip(c: float) -> float:
    """float32(1) / float32(c), as a Python float (exact in float32)."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt: the float64 root rounds to the same
    float32 value as an exact float32 root."""
    return torch.sqrt(x.double()).float()


#: clamp of a rounded pixel or voxel coordinate before the integer cast
PIX_CLAMP = float(1 << 24)


def rint_index(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to +-2^24, cast to int64."""
    return torch.round(x).clamp(-PIX_CLAMP, PIX_CLAMP).long()
