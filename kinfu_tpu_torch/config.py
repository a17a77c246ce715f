"""Runtime configuration for the KinectFusion pipeline (port of
kinfu_tpu/config.py, field for field, with the same defaults and mode
choices).

What "auto" resolves to differs from the JAX package, because the port
runs on CUDA instead of a TPU:

  - fused_mode / integrate_mode / raycast_mode "auto": the fused step with
    the warped integrate and raycast kernels on a CUDA device whenever
    `ops.facewarp.warp_dims_ok` holds (pipeline/kinfu.py::fused_supported).
    Off CUDA, "auto" selects the non-fused step, as the JAX package does
    off its TPU: the gather integrate and the "hier" raycast
    (volume/integrate.py, volume/raycast.py); `fused_mode="on"` runs the
    fused step with the kernels' plain PyTorch versions on any device.
  - icp_mode "auto": "warped" (the ICP kernel K1) on a CUDA device,
    "gather" on the CPU, as the JAX package picks the warped kernel on its
    accelerator and "gather" on the CPU (kinfu_tpu/tracking/icp.py:139-140).
    An explicit "warped" on the CPU runs K1's plain version; an explicit
    "gather" is plain PyTorch on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KinFuParams:
    """All pipeline hyperparameters (kinfu_tpu/config.py:21-142)."""

    # ---- surface measurement ----
    pyramid_height: int = 3
    bfilter_kernel_size: int = 5
    bfilter_spatial_sigma: float = 10.0
    bfilter_color_sigma: float = 10.0
    #: far clip in metres applied after mm->m scaling
    dfilter_dist: float = 5.0
    #: mm -> m
    depth_scale: float = 0.001
    #: relative depth-discontinuity threshold for normal invalidation
    normal_disc_threshold: float = 0.1

    # ---- ICP ----
    icp_dist_threshold: float = 0.015
    #: degrees; compared via sin(angle)
    icp_angle_threshold: float = 30.0
    #: iterations per pyramid level, index = level (0 = finest)
    icp_iters: Tuple[int, ...] = (4, 5, 10)
    #: "gather" = plain PyTorch normal equations; "warped" = the fused ICP
    #: kernel K1 (its plain version on the CPU); "auto" = "warped" on CUDA,
    #: "gather" on the CPU
    icp_mode: str = "auto"

    # ---- TSDF volume ----
    #: voxels per axis as (X, Y, Z)
    volume_dims: Tuple[int, int, int] = (512, 512, 512)
    #: metres per axis as (X, Y, Z)
    volume_range: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    #: TSDF truncation distance in metres; None -> 2.1 * range_x / dims_x
    trunc_dist: float | None = None
    #: world-frame position of the volume's (0,0,0) corner
    volume_origin: Tuple[float, float, float] | None = None
    tsdf_max_weight: int = 64
    #: fusion path: "warped" = face-warp kernels (K2 + K3); "gather" = the
    #: per-voxel projection in plain PyTorch; "auto" = warped on CUDA where
    #: eligible, gather elsewhere (volume/integrate.py::resolve_integrate_mode)
    integrate_mode: str = "auto"

    # ---- raycast ----
    #: ray-march step in voxels of the "step" and "hier" marches
    raycast_step_voxels: float = 1.0
    #: "warped" = cube-face plane sweep (K4 + K5); "step" = the march (M1);
    #: "hier" = the march that skips empty 8^3 blocks (M2); "auto" = warped
    #: on CUDA where eligible, else "hier", or "step" where a dim is not a
    #: multiple of 8 (volume/raycast.py::resolve_raycast_mode)
    raycast_mode: str = "auto"
    #: (size_px, focal_px) of the virtual face grid of the warped raycast
    raycast_face: Tuple[int, float] = (640, 261.0)
    #: the warped integrate and the warped raycast, the raycast gated by
    #: the fusion's face flags (pipeline/kinfu.py::update_volume): "auto" =
    #: on CUDA when the warped kernels are eligible, "on" = on any device
    #: (plain PyTorch versions on the CPU), "off" = never
    fused_mode: str = "auto"

    # ---- extraction ----
    max_extracted_points: int = 2_000_000

    _MODE_CHOICES = {
        "icp_mode": ("auto", "warped", "gather"),
        "integrate_mode": ("auto", "warped", "gather"),
        "raycast_mode": ("auto", "warped", "hier", "step"),
        "fused_mode": ("auto", "on", "off"),
    }

    def __post_init__(self):
        for field, choices in self._MODE_CHOICES.items():
            val = getattr(self, field)
            if val not in choices:
                raise ValueError(f"{field}={val!r}; must be one of {choices}")
        if self.trunc_dist is None:
            object.__setattr__(
                self,
                "trunc_dist",
                2.1 * self.volume_range[0] / self.volume_dims[0],
            )
        if self.volume_origin is None:
            rx, ry, _ = self.volume_range
            object.__setattr__(self, "volume_origin", (-rx / 2.0, -ry / 2.0, 0.5))

    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        """Metres per voxel, per axis."""
        return tuple(r / d for r, d in zip(self.volume_range, self.volume_dims))

    @property
    def volume_pose(self) -> np.ndarray:
        """4x4 world-from-volume transform (pure translation by default)."""
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = np.asarray(self.volume_origin, dtype=np.float32)
        return T

    def level_iters_coarse_to_fine(self) -> Tuple[Tuple[int, int], ...]:
        """(level, iters) pairs, coarsest level first."""
        n = len(self.icp_iters)
        return tuple((lvl, self.icp_iters[lvl]) for lvl in range(n - 1, -1, -1))

    def replace(self, **kw) -> "KinFuParams":
        return dataclasses.replace(self, **kw)


def tiny_params(dim: int = 64, levels: int = 1) -> KinFuParams:
    """Small configuration for tests / CPU runs."""
    return KinFuParams(
        pyramid_height=levels,
        icp_iters=tuple([4, 5, 10][:levels]),
        volume_dims=(dim, dim, dim),
        volume_range=(3.0, 3.0, 3.0),
        max_extracted_points=200_000,
    )
