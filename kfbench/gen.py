"""The benchmark's one traffic generator: it reads a mix's parameters
(`traffic/<mix>.json`) and the seed, and makes the frames a sensor would
deliver (depth as uint16 millimetres, colour as uint8, on the host) with
the ground-truth camera pose of each.

A mix names a scene kind, a camera kind and, under an optional "sensor"
list, perturbations of what the sensor delivers, each with its numbers.
Each kind is a file that the generator finds by its name:
  - `traffic/scene/<kind>.py`: `make(cfg, rng)` gives the scene's
    primitives (`Prim`);
  - `traffic/camera/<kind>.py`: `make(cfg, rng)` gives an object with
    `unique` (the rendered positions), `render_pose(i)` (world from camera
    of position i), `image_of(k)` and `pose(k)` (the image and ground
    truth of stream frame k);
  - `traffic/sensor/<kind>.py`: `make(cfg, rng, frames)` gives a function
    `(k, colour, depth_mm) -> (colour, depth_mm)` applied, in the list's
    order, to stream frame k. It runs inside the measured window, so it
    prepares its work from `frames` in `make` and only looks it up there.
The seed's draws are taken in that order: scene, camera, perturbations.

Rendering is exact ray casting of the primitives in float64 on the given
device, 8 frames at a time; depth is z-depth rounded to the millimetre,
colour is shaded by depth. The same seed gives the same bytes.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def kind(group: str, name: str):
    """The module of kind `name` in `traffic/<group>/`."""
    path = HERE / "traffic" / group / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kfbench_{group}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Frames(NamedTuple):
    #: uint16 [U, H, W] millimetres and uint8 [U, H, W, 3], on the host
    depth_mm: np.ndarray
    color: np.ndarray


class Traffic:
    """A mix made concrete for one seed: the rendered images and, for any
    frame index k of the stream, its image and its ground-truth pose
    (world from camera, 4x4 float64, the first frame's camera at the
    world's origin)."""

    def __init__(self, mix: dict, seed: int, cam, device):
        self.mix = mix
        rng = np.random.default_rng(seed)
        scene_cfg, cam_cfg = mix["scene"], mix["camera"]
        self.prims = kind("scene", scene_cfg["kind"]).make(scene_cfg, rng)
        self.camera = kind("camera", cam_cfg["kind"]).make(cam_cfg, rng)
        poses = np.stack([self.camera.render_pose(i) for i in range(self.camera.unique)])
        self.frames = render(self.prims, poses, cam, device)
        self.sensor = [kind("sensor", s["kind"]).make(s, rng, self.frames)
                       for s in mix.get("sensor", [])]
        self._first_inv = np.linalg.inv(self.camera.pose(0))

    def image_of(self, k: int) -> int:
        return self.camera.image_of(k)

    def frame(self, k: int):
        """(colour, depth_mm) host arrays of stream frame k, as a sensor
        hands them over."""
        i = self.image_of(k)
        color, depth = self.frames.color[i], self.frames.depth_mm[i]
        for f in self.sensor:
            color, depth = f(k, color, depth)
        return color, depth

    def gt_pose(self, k: int) -> np.ndarray:
        return self._first_inv @ self.camera.pose(k)


# ---------------------------------------------------------------- scene primitives

class Prim(NamedTuple):
    kind: str  # "sphere" | "plane" | "box"
    a: np.ndarray  # centre / point / lo
    b: np.ndarray  # (radius,) / unit normal / hi


def unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


# ---------------------------------------------------------------- render

def _hit(p: Prim, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Ray parameter s of the first hit (the ray is o + s d, d of unit
    z-depth), inf where none. o [B, 1, 1, 3], d [B, H, W, 3], float64."""
    inf = torch.full(d.shape[:-1], math.inf, dtype=d.dtype, device=d.device)
    a = torch.as_tensor(p.a, dtype=d.dtype, device=d.device)
    b = torch.as_tensor(p.b, dtype=d.dtype, device=d.device)
    if p.kind == "sphere":
        oc = o - a
        qa = (d * d).sum(-1)
        qb = 2.0 * (d * oc).sum(-1)
        qc = (oc * oc).sum(-1) - b[0] * b[0]
        disc = qb * qb - 4.0 * qa * qc
        sq = torch.sqrt(disc.clamp(min=0.0))
        s1 = (-qb - sq) / (2.0 * qa)
        s2 = (-qb + sq) / (2.0 * qa)
        s = torch.where(s1 > 1e-6, s1, s2)
        return torch.where((disc >= 0) & (s > 1e-6), s, inf)
    if p.kind == "plane":
        den = (d * b).sum(-1)
        s = ((a - o) * b).sum(-1) / torch.where(den.abs() < 1e-12, 1e-12, den)
        return torch.where((den.abs() > 1e-12) & (s > 1e-6), s, inf)
    safe = torch.where(d.abs() < 1e-12, 1e-12, d)
    t1 = (a - o) / safe
    t2 = (b - o) / safe
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    s = torch.where(tmin > 1e-6, tmin, tmax)
    return torch.where((tmax > tmin.clamp(min=0.0)) & (s > 1e-6), s, inf)


def render(prims: List[Prim], poses: np.ndarray, cam, device, batch: int = 8) -> Frames:
    """Depth (uint16 mm) and colour (uint8) of every pose, on the host."""
    dt = torch.float64
    v = torch.arange(cam.height, dtype=dt, device=device)[:, None]
    u = torch.arange(cam.width, dtype=dt, device=device)[None, :]
    d_cam = torch.stack([((u - cam.cx) / cam.fx).expand(cam.height, cam.width),
                         ((v - cam.cy) / cam.fy).expand(cam.height, cam.width),
                         torch.ones(cam.height, cam.width, dtype=dt, device=device)], -1)
    depths, colors = [], []
    for s in range(0, len(poses), batch):
        T = torch.as_tensor(poses[s:s + batch], dtype=dt, device=device)
        d = torch.einsum("bij,hwj->bhwi", T[:, :3, :3], d_cam)
        o = T[:, None, None, :3, 3]
        hit = torch.full(d.shape[:-1], math.inf, dtype=dt, device=device)
        for p in prims:
            hit = torch.minimum(hit, _hit(p, o, d))
        depth = torch.where(torch.isfinite(hit) & (hit <= 10.0), hit, 0.0)
        mm = torch.round(depth * 1000.0).clamp(0, 65535)
        shade = (depth / 4.0).clamp(0.0, 1.0)
        col = torch.stack([shade * 255.0, (1.0 - shade) * 255.0, torch.full_like(shade, 128.0)],
                          -1)
        depths.append(mm.to(torch.int32).cpu().numpy().astype(np.uint16))
        colors.append(col.to(torch.uint8).cpu().numpy())
    return Frames(np.concatenate(depths), np.concatenate(colors))
