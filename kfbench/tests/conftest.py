"""Shared small-size set-ups for the benchmark's CPU tests: the cells'
configurations cut to 160x120 frames and a 128^3 volume, a two-level
pyramid and ICP (3, 4), the size at which the port tracks on the CPU."""

import copy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def small_entry(workload: str, fused: bool = False) -> dict:
    from kfbench import harness

    e = copy.deepcopy(harness.load_cell(workload, ROOT))
    c = e["config"]
    c["sensor"] = {"width": 160, "height": 120, "fx": 131.25, "fy": 131.25, "cx": 79.5,
                   "cy": 59.5}
    c["params"].update(volume_dims=[128, 128, 128], pyramid_height=2, icp_iters=[3, 4])
    if fused:
        c["params"].update(fused_mode="on", icp_mode="warped")
    m = e["mix"]
    m["camera"]["unique_frames"] = 8 if m["camera"]["kind"] == "orbit" else 50
    m["warmup_frames"] = 2
    return e

