"""Scene "corridor": two walls, a floor and a ceiling along +z, and in
every period of `period_m` the boxes of `blocks`. The seed moves every
block by up to `jitter_m` (the same in every period, so the corridor
repeats)."""

from typing import List

import numpy as np

from kfbench.gen import Prim


def make(cfg: dict, rng) -> List[Prim]:
    hw, floor_y, ceil_y = (float(cfg[k]) for k in ("half_width_m", "floor_y", "ceiling_y"))
    period = float(cfg["period_m"])
    prims = [Prim("plane", np.array([-hw, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
             Prim("plane", np.array([hw, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),
             Prim("plane", np.array([0.0, floor_y, 0.0]), np.array([0.0, -1.0, 0.0])),
             Prim("plane", np.array([0.0, ceil_y, 0.0]), np.array([0.0, 1.0, 0.0]))]
    j = float(cfg["jitter_m"])
    blocks = [(np.asarray(b["lo"], np.float64), np.asarray(b["hi"], np.float64),
               rng.uniform(-j, j, 3) * np.asarray(b.get("move", [1, 1, 1]), np.float64))
              for b in cfg["blocks"]]
    lo_n, hi_n = (int(v) for v in cfg["periods"])
    for n in range(lo_n, hi_n):
        for lo, hi, d in blocks:
            shift = d + np.array([0.0, 0.0, n * period])
            prims.append(Prim("box", lo + shift, hi + shift))
    return prims
