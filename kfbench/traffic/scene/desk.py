"""Scene "desk": a sphere before three tilted planes (a back wall, a floor
and a side wall), the arrangement that constrains all six degrees of
freedom of ICP. The seed moves each part by up to `jitter_m` and scales
the sphere by up to `radius_jitter`."""

from typing import List

import numpy as np

from kfbench.gen import Prim, unit


def make(cfg: dict, rng) -> List[Prim]:
    j = float(cfg["jitter_m"])

    def off():
        return rng.uniform(-j, j, 3)

    c = np.asarray(cfg["sphere_centre"], np.float64) + off()
    r = float(cfg["sphere_radius"]) * (1.0 + rng.uniform(-1, 1) * float(cfg["radius_jitter"]))
    prims = [Prim("sphere", c, np.array([r]))]
    for p in cfg["planes"]:
        n = unit(p["normal"])
        prims.append(Prim("plane", np.asarray(p["point"], np.float64) + n * rng.uniform(-j, j), n))
    return prims
