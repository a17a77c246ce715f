"""Camera "walk": straight ahead along +z at `step_m` a frame from a
lateral start the seed draws within +-`lateral_m`; a period holds
`unique_frames` frames, which repeat while the pose keeps advancing."""

import numpy as np


class Walk:
    """Straight ahead along +z; the images repeat every `unique_frames`
    frames (one period of the scene) while the pose keeps advancing."""

    def __init__(self, cfg: dict, rng):
        self.step = float(cfg["step_m"])
        self.x0 = rng.uniform(-1, 1) * float(cfg["lateral_m"])
        self.unique = int(cfg["unique_frames"])

    def image_of(self, k: int) -> int:
        return k % self.unique

    def pose(self, k: int) -> np.ndarray:
        T = np.eye(4)
        T[:3, 3] = (self.x0, 0.0, self.step * k)
        return T

    def render_pose(self, i: int) -> np.ndarray:
        return self.pose(i)


make = Walk
