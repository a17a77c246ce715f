"""The generator: the same seed gives the same bytes, the corridor
repeats every period, and the orbit's back-and-forth poses are
continuous."""

import json

import numpy as np
import pytest

from kfbench import gen
from kfbench.reference.kinfu import Camera

from .conftest import ROOT

CAM = Camera(160, 120, 131.25, 131.25, 79.5, 59.5)


def _mix(name: str, **camera) -> dict:
    m = json.loads((ROOT / "kfbench" / "traffic" / f"{name}.json").read_text())
    m["camera"].update(camera)
    return m


@pytest.mark.parametrize("mix", ["orbit", "corridor"])
def test_same_seed_same_bytes(mix):
    m = _mix(mix, unique_frames=6)
    a = gen.Traffic(m, 2**31 + 5, CAM, "cpu")
    b = gen.Traffic(m, 2**31 + 5, CAM, "cpu")
    c = gen.Traffic(m, 2**31 + 6, CAM, "cpu")
    assert a.frames.depth_mm.dtype == np.uint16 and a.frames.color.dtype == np.uint8
    assert np.array_equal(a.frames.depth_mm, b.frames.depth_mm)
    assert np.array_equal(a.frames.color, b.frames.color)
    assert all(np.array_equal(a.gt_pose(k), b.gt_pose(k)) for k in range(20))
    assert not np.array_equal(a.frames.depth_mm, c.frames.depth_mm)
    assert (a.frames.depth_mm > 0).mean() > 0.8


def test_corridor_repeats_every_period():
    m = _mix("corridor")
    t = gen.Traffic(m, 12345, CAM, "cpu")
    for k in (0, 7, 49):
        ca, da = t.frame(k)
        cb, db = t.frame(k + 50)
        assert np.array_equal(da, db) and np.array_equal(ca, cb)
        step = t.gt_pose(k + 50)[:3, 3] - t.gt_pose(k)[:3, 3]
        assert np.allclose(step, [0.0, 0.0, 0.7], atol=1e-9)
    # the image at a pose one period on, rendered from that pose, is the
    # same scene: the repetition is the corridor's, not a replay
    poses = np.stack([t.camera.pose(3), t.camera.pose(53)])
    far = gen.render(t.prims, poses, CAM, "cpu")
    a, b = (far.depth_mm[i].astype(int) for i in range(2))
    near = (a < 5000) & (b < 5000)  # within the configurations' far clip
    assert near.mean() > 0.5
    assert (np.abs(a - b)[near] <= 1).mean() > 0.999


def test_orbit_pingpong_is_continuous():
    m = _mix("orbit", unique_frames=10)
    t = gen.Traffic(m, 99, CAM, "cpu")
    imgs = [t.image_of(k) for k in range(40)]
    assert imgs[:12] == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 8, 7]
    assert all(abs(a - b) == 1 for a, b in zip(imgs, imgs[1:]))
    step = np.radians(m["camera"]["deg_per_frame"])
    for k in range(39):
        rel = np.linalg.inv(t.gt_pose(k)) @ t.gt_pose(k + 1)
        angle = np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))
        assert angle == pytest.approx(step, rel=1e-6)
        ca, da = t.frame(k)
        assert np.array_equal(da, t.frames.depth_mm[imgs[k]])


def test_sensor_kind_is_found_by_file():
    """A perturbation named in a mix's "sensor" list is the file
    traffic/sensor/<kind>.py, applied to the stream frames it names and
    drawing nothing from the seed that the scene and camera use."""
    plain = gen.Traffic(_mix("orbit", unique_frames=6), 7, CAM, "cpu")
    m = _mix("orbit", unique_frames=6)
    m["sensor"] = [{"kind": "blank", "every": 10, "count": 3}]
    t = gen.Traffic(m, 7, CAM, "cpu")
    assert np.array_equal(t.frames.depth_mm, plain.frames.depth_mm)
    for k in range(25):
        ca, da = t.frame(k)
        cb, db = plain.frame(k)
        assert np.array_equal(ca, cb)
        if k % 10 >= 7:
            assert da.dtype == np.uint16 and not da.any()
        else:
            assert np.array_equal(da, db)
