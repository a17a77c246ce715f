"""The port's two integrate paths held against each other: the warped
integrate (`ops/face_integrate.py::integrate_warped`, K2 + K3's plain
versions here) against the gather integrate (`volume/integrate.py::
integrate_gather`, the path of an untileable volume on the card).

Mirrors of five tests of tests/test_pallas_integrate.py, with their
thresholds and their 160x120 / 128^3 scale: test_warped_matches_gather_
near_axis, test_plane_surface_parity, test_warped_full_coverage_tilted,
test_warped_backward_camera and test_color_band_parity; and the same
comparison from three cameras inside the volume that look along -x, -y
and +y, the faces that no orbit reaches, where the port's face flags must
also be the JAX package's (`kinfu_tpu/ops/pallas_integrate.py::
faces_needed`, the one JAX reference here). What "parity" means (DIVERGENCES.md
items 17-19): the warped path measures signed distance along the ray, the
gather path along the camera z axis, so in-band values differ by a
secant factor but the zero crossing (the surface) is the same point; the
tests hold (a) the update footprints, (b) the signs away from the surface,
(c) the zero crossings to about a voxel, and (d) the values where the
scaling is provably small.
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from kinfu_tpu.geometry import se3 as jse3
from kinfu_tpu.geometry.intrinsics import Intrinsics as JaxIntrinsics
from kinfu_tpu.ops.pallas_integrate import faces_needed as jax_faces_needed

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import SyntheticScene, default_test_scene, plane, sphere
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
from kinfu_tpu_torch.ops.face_integrate import faces_needed, integrate_warped
from kinfu_tpu_torch.ops.facewarp import FaceSpec, face_frames
from kinfu_tpu_torch.tools.raycast_parity_probe import face_counts
from kinfu_tpu_torch.volume.integrate import integrate_gather
from kinfu_tpu_torch.volume.tsdf import create_volume, tsdf_to_float

torch.set_num_threads(2)

INTR = Intrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=79.5, cy=59.5)
PARAMS = KinFuParams(pyramid_height=1, icp_iters=(4,), volume_dims=(128, 128, 128),
                     volume_range=(3.0, 3.0, 3.0))
#: tests/test_pallas_integrate.py's face: 256 px covers the +-45 deg
#: ownership cone plus margin at f = 104
SPEC = FaceSpec(size=256, focal=104.0, levels=6)


def _roty(deg: float, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    a = np.radians(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    T[:3, 3] = t
    return T


def _plane_scene():
    n = np.array([0.25, 0.15, -1.0])
    return SyntheticScene(primitives=[plane(np.array([0.0, 0.0, 2.2]), n / np.linalg.norm(n))])


def _backward_scene():
    return SyntheticScene(primitives=[sphere((0.25, 0.0, 1.5), 0.5),
                                      plane(np.array([0.0, 0.0, 0.7]),
                                            np.array([0.0, 0.0, 1.0]))])


def _rotx(deg: float, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    a = np.radians(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    T[:3, 3] = t
    return T


def _room_scene():
    """Walls at x = -1.1 and y = +-1.1 with a sphere before each, inside
    the 3 m volume: what the cameras of INSIDE see (chip_smoke.py phase 4e
    renders the same scene at 640x480)."""
    return SyntheticScene(primitives=[
        plane(np.array([-1.1, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
        plane(np.array([0.0, 1.1, 0.0]), np.array([0.0, -1.0, 0.0])),
        plane(np.array([0.0, -1.1, 0.0]), np.array([0.0, 1.0, 0.0])),
        sphere((-0.5, 0.2, 2.2), 0.3), sphere((0.2, 0.6, 1.8), 0.25),
        sphere((-0.2, -0.6, 2.2), 0.25)])


#: the scenes by name (a cache key)
SCENES = {"default": default_test_scene, "plane": _plane_scene, "backward": _backward_scene,
          "room": _room_scene}

#: cameras inside the volume and the face each makes live: a yaw of -100
#: degrees (looking along -x, with -z), and pitches of +-90 degrees
#: (looking along -y and +y; the camera's y axis points down)
INSIDE = {"-x": _roty(-100.0, t=(0.5, 0.0, 2.2)), "-y": _rotx(90.0, t=(0.0, 0.3, 2.0)),
          "+y": _rotx(-90.0, t=(0.0, -0.3, 2.0))}


@functools.lru_cache(maxsize=None)
def _fuse(scene: str, pose: tuple, faces):
    """(gather, warped) numpy volumes, each one frame fused into an empty
    volume; the gather result also depends on the pose only."""
    T = np.asarray(pose, np.float32).reshape(4, 4)
    depth_raw, color = SCENES[scene]().render_frame(T, INTR)
    depth_m = torch.as_tensor((depth_raw * 0.001).astype(np.float32))
    color = torch.as_tensor(color)
    cam = pose_from_matrix(torch.as_tensor(T))
    v2c = compose(inverse(cam), pose_from_matrix(torch.as_tensor(PARAMS.volume_pose)))
    out = []
    for fuse in (lambda v: integrate_gather(v, depth_m, color, v2c, INTR, PARAMS),
                 lambda v: integrate_warped(v, depth_m, color, v2c, INTR, PARAMS, spec=SPEC,
                                            faces=faces)):
        vol = create_volume(PARAMS.volume_dims, device="cpu")
        fuse(vol)
        out.append({"tsdf": tsdf_to_float(vol.tsdf).numpy(), "weight": vol.weight.numpy(),
                    "color": vol.color.numpy()})
    return tuple(out)


def _fuse_both(T, faces, scene="default"):
    return _fuse(scene, tuple(np.asarray(T, np.float32).ravel().tolist()), faces)


def _crossing_depth(t, wmask):
    """Per (y, x) column: fractional z index of the first +,- zero crossing
    of the TSDF (NaN when none). The surface-position witness."""
    valid = wmask[:-1] & wmask[1:]
    cross = valid & (t[:-1] > 0) & (t[1:] < 0)
    has = cross.any(axis=0)
    first = cross.argmax(axis=0).astype(np.float32)
    zi = np.take_along_axis(t, first[None].astype(int), 0)[0]
    zn = np.take_along_axis(t, first[None].astype(int) + 1, 0)[0]
    frac = zi / np.maximum(zi - zn, 1e-9)
    return np.where(has, first + frac, np.nan)


def _compare(g, w, min_ratio, sign_min=0.95):
    gw = g["weight"] > 0
    ww = w["weight"] > 0
    gt, wt = g["tsdf"], w["tsdf"]

    assert ww.sum() > 1000
    ratio = ww.sum() / gw.sum()
    assert ratio > min_ratio, f"updated-voxel ratio {ratio}"
    # a small fringe of warped updates past the gather footprint (nearest
    # mip sampling, DIVERGENCES.md 18), all within 2 voxels of it
    extra = (ww & ~gw).sum() / ww.sum()
    assert extra < 0.06, f"warped-only fraction {extra}"
    dil = gw.copy()
    for ax in (0, 1, 2):
        for sh in (-2, -1, 1, 2):
            dil |= np.roll(gw, sh, axis=ax)
    stray = (ww & ~dil).sum()
    assert stray / ww.sum() < 1e-3, f"{stray} warped updates far from frustum"

    # the along-ray scaling rescales in-band values but cannot flip a sign
    both = gw & ww & (np.abs(gt) > 0.1) & (np.abs(gt) < 0.99)
    if both.sum() > 500:
        agree = (np.sign(gt[both]) == np.sign(wt[both])).mean()
        assert agree > sign_min, f"sign agreement {agree}"

    # the first +,- crossing along z, on locally smooth columns
    gc = _crossing_depth(gt, gw)
    wc = _crossing_depth(wt, ww)
    wins = sliding_window_view(np.pad(gc, 1, mode="edge"), (3, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN windows
        rough = np.nanmax(wins, axis=(2, 3)) - np.nanmin(wins, axis=(2, 3))
    bothc = np.isfinite(gc) & np.isfinite(wc) & (rough < 1.0)
    if bothc.sum() > 200:
        d = np.abs(gc[bothc] - wc[bothc])
        assert np.percentile(d, 90) < 0.6, np.percentile(d, 90)
        assert np.median(d) < 0.25, np.median(d)


def test_warped_matches_gather_near_axis():
    g, w = _fuse_both(np.eye(4, dtype=np.float32), faces=("+z",))
    _compare(g, w, min_ratio=0.9)
    # near the axis the along-ray scaling is <= sec(31 deg)^2 ~ 1.25, so the
    # values must also agree near the surface
    both = (g["weight"] > 0) & (w["weight"] > 0)
    near = both & (np.abs(g["tsdf"]) < 0.2)
    assert near.sum() > 500
    assert np.median(np.abs(g["tsdf"][near] - w["tsdf"][near])) < 0.06


def test_plane_surface_parity():
    """A scene without discontinuities: the zero crossings match the gather
    path's to well under a voxel."""
    g, w = _fuse_both(np.eye(4, dtype=np.float32), faces=("+z",), scene="plane")
    gc = _crossing_depth(g["tsdf"], g["weight"] > 0)
    wc = _crossing_depth(w["tsdf"], w["weight"] > 0)
    both = np.isfinite(gc) & np.isfinite(wc)
    assert both.sum() > 3000
    d = np.abs(gc[both] - wc[both])
    assert np.percentile(d, 95) < 0.75, np.percentile(d, 95)
    assert np.median(d) < 0.25, np.median(d)
    # crossings found in (almost) the same columns
    assert (np.isfinite(gc) != np.isfinite(wc)).mean() < 0.05


def test_warped_full_coverage_tilted():
    """55 degrees off the axis: the frustum straddles the +z and +x
    ownership cones, which faces="auto" covers and +z alone cannot."""
    T = _roty(55.0)
    g, w = _fuse_both(T, faces="auto")
    # grazing incidence flips more band-edge signs than head-on
    _compare(g, w, min_ratio=0.85, sign_min=0.85)
    auto_frac = (w["weight"] > 0).sum() / (g["weight"] > 0).sum()
    _, w_zonly = _fuse_both(T, faces=("+z",))
    zfrac = (w_zonly["weight"] > 0).sum() / (g["weight"] > 0).sum()
    assert zfrac < auto_frac - 0.15, f"+z-only {zfrac} vs auto {auto_frac}"


def test_warped_backward_camera():
    """About 170 degrees: the camera inside the volume looking back along
    -z, where no voxel lies in front of the +z face."""
    g, w = _fuse_both(_roty(170.0, t=(0.0, 0.0, 3.3)), faces="auto", scene="backward")
    _compare(g, w, min_ratio=0.85)


def test_color_band_parity():
    """Colour is averaged only within the half-truncation band; the fused
    colour matches the gather path's where both coloured a voxel."""
    g, w = _fuse_both(np.eye(4, dtype=np.float32), faces=("+z",))
    gc, wc = g["color"], w["color"]
    both = (gc != 0) & (wc != 0)
    assert both.sum() > 300
    for shift in (16, 8, 0):  # packed 0xRRGGBB, channel by channel
        a = (gc[both] >> shift) & 0xFF
        b = (wc[both] >> shift) & 0xFF
        match = np.abs(a.astype(int) - b.astype(int)) <= 8
        assert match.mean() > 0.9, f"shift {shift}: {match.mean()}"


@pytest.mark.parametrize("face", list(INSIDE))
def test_warped_inside_faces(face):
    """A camera inside the volume looking along -x, -y or +y: the port's
    face flags are the JAX package's, they include that face, the warped
    fusion writes voxels of that face and of no face gated off, and it
    matches the gather fusion with test_warped_backward_camera's
    thresholds."""
    T = INSIDE[face]
    cam = pose_from_matrix(torch.as_tensor(T))
    vol_pose = pose_from_matrix(torch.as_tensor(PARAMS.volume_pose))
    flags = faces_needed(compose(inverse(cam), vol_pose), INTR).tolist()
    jv2c = jse3.compose(jse3.inverse(jse3.pose_from_matrix(jnp.asarray(T))),
                        jse3.pose_from_matrix(jnp.asarray(PARAMS.volume_pose)))
    jflags = jax_faces_needed(jv2c, JaxIntrinsics(INTR.width, INTR.height, INTR.fx, INTR.fy,
                                                  INTR.cx, INTR.cy))
    names = [f.name for f in face_frames()]
    assert flags == [bool(jflags[n]) for n in names]
    gated = {n for n, g in zip(names, flags) if g}
    assert face in gated

    g, w = _fuse_both(T, faces="auto", scene="room")
    no_hits = torch.zeros((INTR.height, INTR.width, 3))
    counts = face_counts(torch.as_tensor(w["weight"]), no_hits, compose(inverse(vol_pose), cam),
                         INTR, PARAMS)
    live = {n for n, (vox, _) in counts.items() if vox > 0}
    assert face in live and live <= gated, (counts, gated)
    assert counts[face][0] > 1000
    _compare(g, w, min_ratio=0.85)
