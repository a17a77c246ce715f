"""Sensor perturbation "blank": the depth of the last `count` of every
`every` stream frames is blank (all zero), as a covered or saturated
sensor delivers it; the colour is left as it is."""

import numpy as np


def make(cfg: dict, rng, frames):
    every, count = int(cfg["every"]), int(cfg["count"])
    zero = np.zeros_like(frames.depth_mm[0])

    def apply(k: int, color, depth):
        return (color, zero) if k % every >= every - count else (color, depth)

    return apply
