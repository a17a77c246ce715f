"""ICL-NUIM synthetic RGB-D dataset loader (living room / office sequences;
a copy of kinfu_tpu/data/icl_nuim.py on the port's TUM loader).

Uses the TUM-compatible distribution of ICL-NUIM (rgb.txt / depth.txt /
groundtruth.txt association lists, 16-bit depth PNGs at 1/5000 m), which is
how the benchmark is normally consumed; the only differences from a TUM
sequence are the camera intrinsics and the left-handed ground-truth
convention of the raw (non-TUM) files, which the TUM-format export already
fixes. No reference equivalent (the reference only reads its bundled
folder, depth_sensor.cpp:13-46)."""

from __future__ import annotations

from kinfu_tpu_torch.data.tum import TUMDataset
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

#: ICL-NUIM camera model (Handa et al., ICRA 2014)
ICL_INTRINSICS = Intrinsics(
    width=640,
    height=480,
    fx=481.20,
    fy=-480.00,  # negative fy: ICL's raw convention; TUM-format exports flip it
    cx=319.50,
    cy=239.50,
    depth_scale=1 / 5000,
)

#: intrinsics for the TUM-format export (right-handed, positive fy)
ICL_TUM_FORMAT_INTRINSICS = Intrinsics(
    width=640,
    height=480,
    fx=481.20,
    fy=480.00,
    cx=319.50,
    cy=239.50,
    depth_scale=1 / 5000,
)


class ICLNuimDataset(TUMDataset):
    """TUM-format ICL-NUIM sequence (e.g. living_room_traj2_frei_png)."""

    def __init__(self, path: str, intrinsics: Intrinsics | None = None):
        super().__init__(path, intrinsics or ICL_TUM_FORMAT_INTRINSICS)
