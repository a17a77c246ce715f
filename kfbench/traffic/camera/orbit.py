"""Camera "orbit": a circle about `target` at `deg_per_frame`, over
`unique_frames` positions centred on an angle the seed draws within
+-`start_deg`, rendered once and played back and forth."""

import math

import numpy as np


class Orbit:
    """A circle about `target` in the camera's x-z plane, played back and
    forth over `unique_frames` positions: 0, 1, .., U-1, U-2, .., 1, 0, 1, .."""

    def __init__(self, cfg: dict, rng):
        self.target = np.asarray(cfg["target"], np.float64)
        self.step = math.radians(float(cfg["deg_per_frame"]))
        self.a0 = math.radians(rng.uniform(-1, 1) * float(cfg["start_deg"]))
        self.unique = int(cfg["unique_frames"])

    def image_of(self, k: int) -> int:
        u = self.unique
        if u < 2:
            return 0
        m = k % (2 * u - 2)
        return m if m < u else 2 * u - 2 - m

    def render_pose(self, i: int) -> np.ndarray:
        a = self.a0 + self.step * (i - 0.5 * (self.unique - 1))
        ca, sa = math.cos(a), math.sin(a)
        R = np.array([[ca, 0.0, sa], [0.0, 1.0, 0.0], [-sa, 0.0, ca]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.target - R @ self.target
        return T

    def pose(self, k: int) -> np.ndarray:
        return self.render_pose(self.image_of(k))


make = Orbit
