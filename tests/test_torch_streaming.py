"""The port's streaming volume (kinfu_tpu_torch/volume/stream.py,
kinfu_tpu_torch/pipeline/streaming.py) against the JAX package.

  - `shift_volume` and the in-place `shift_volume_` bit for bit against
    JAX's on non-cubic [16, 24, 32] int16 / int16 / int32 volumes,
    in-range and out-of-range shifts; `shift_volume_` keeps the volume's
    tensors (a zero shift also their bits) and counts its calls and moves;
  - `camera_centering_shift` int32-exact against JAX's on seeded positions,
    half-voxel ties and NaN included;
  - the streaming step from each JAX state, on the non-fused path (the
    CPU default) at tests/test_mapping.py::test_streaming_pipeline_follows_
    camera's configuration: `origin_vox` exact on every frame, the pose
    within test_torch_mapping.py's POSE_TOL and the volume within its
    shares (tests/test_torch_mapping.py's docstring says why one step's
    poses differ by ulps). The JAX step runs in a child process without
    FMA and with at most SSE4.2 (tests/torch_jaxref.py), where the gather
    integrate is bit for bit;
  - the mirror of tests/test_fused_streaming.py: the port's fused
    streaming step (K2-K5's plain versions) against its non-fused one
    with the same warped kernels, at that file's configuration and
    assertions; both shift the grid before the volume update;
  - an all-zero frame after a shift: the map is wiped, the grid returns to
    the configured origin and the next frame bootstraps, on both paths.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu.volume import stream as jstream
from kinfu_tpu.volume.tsdf import TSDFVolume as JVolume
from kinfu_tpu_torch.config import KinFuParams, tiny_params
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.state import streaming_state_from_numpy, streaming_state_to_numpy
from kinfu_tpu_torch.pipeline.streaming import init_streaming_state, make_streaming_step_fn
from kinfu_tpu_torch.volume.stream import (
    camera_centering_shift,
    shift_counts,
    shift_volume,
    shift_volume_,
)
from kinfu_tpu_torch.volume.tsdf import TSDFVolume, tsdf_to_float

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
#: tests/test_mapping.py::test_streaming_pipeline_follows_camera's
#: configuration (its truncation distance stays tiny_params' 3 m one)
PARAMS = tiny_params(dim=128, levels=2).replace(
    icp_iters=(4, 8), volume_range=(2.0, 2.0, 2.0), volume_origin=(-1.0, -1.0, 0.4))
MARGIN = 0.42
N = 7
POSE_TOL = 1e-5
#: tests/test_fused_streaming.py
ALL_WARPED = dict(pyramid_height=2, icp_iters=(3, 4), volume_dims=(128,) * 3,
                  volume_range=(3.0,) * 3, integrate_mode="warped", raycast_mode="warped",
                  icp_mode="warped", raycast_face=(256, 104.0))


def _walk(n=N):
    """The camera walks forward 2 cm a frame along +z."""
    scene = default_test_scene()
    poses = []
    for k in range(n):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = 0.02 * k
        poses.append(T)
    return [scene.render_frame(T, INTR) for T in poses]


def _track(frames, params=PARAMS, margin=MARGIN, state=None):
    step = make_streaming_step_fn(params, INTR, margin_frac=margin)
    state = state if state is not None else init_streaming_state(params, INTR, device="cpu")
    outs = []
    for d, c in frames:
        state, out = step(state, torch.as_tensor(d), torch.as_tensor(c))
        outs.append((streaming_state_to_numpy(state), out))
    return outs


# ---- the shift ------------------------------------------------------------


SHIFTS = [(0, 0, 0), (2, 0, 0), (0, -3, 5), (-1, -1, -1), (40, 0, 0), (0, 0, -16)]


def _random_arrays(shape=(16, 24, 32)):
    rng = np.random.default_rng(11)
    return (rng.integers(-32767, 32768, shape).astype(np.int16),
            rng.integers(0, 65, shape).astype(np.int16),
            rng.integers(0, 1 << 24, shape).astype(np.int32))


@pytest.mark.parametrize("fn, shift", [(f, s) for f in (shift_volume, shift_volume_)
                                       for s in SHIFTS],
                         ids=[f"{p}shift{k}" for p in ("", "in_place-")
                              for k in range(len(SHIFTS))])
def test_shift_volume_matches_jax(fn, shift):
    """One 3-D gather per array gives the JAX package's three roll-and-mask
    passes bit for bit; so does the in-place form, in the tensors it was
    given."""
    arrays = _random_arrays()
    s = np.asarray(shift, np.int32)
    want = jstream.shift_volume(JVolume(*arrays), s)
    vol = TSDFVolume(*(torch.as_tensor(a).clone() for a in arrays))
    ptrs = [t.data_ptr() for t in vol]
    got = fn(vol, torch.as_tensor(s))
    for name, g, w, a in zip(("tsdf", "weight", "colour"), got, want, arrays):
        assert g.dtype == torch.as_tensor(a).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if fn is shift_volume:
        # the volume it was given is left as it was
        for a, t in zip(arrays, vol):
            np.testing.assert_array_equal(t.numpy(), a)
    else:
        # the volume it was given is the one shifted
        assert got is vol and [t.data_ptr() for t in vol] == ptrs


def test_shift_volume_in_place_counts():
    """A zero shift keeps each tensor's address and bits; the counter adds
    every call, and the calls that move voxels."""
    arrays = _random_arrays()
    vol = TSDFVolume(*(torch.as_tensor(a).clone() for a in arrays))
    ptrs = [t.data_ptr() for t in vol]
    counts = torch.zeros(2, dtype=torch.int64)
    for s in SHIFTS[:1] * 2 + SHIFTS[1:3]:
        shift_volume_(vol, torch.tensor(s, dtype=torch.int32), counts)
        if s == (0, 0, 0):
            assert [t.data_ptr() for t in vol] == ptrs
            for a, t in zip(arrays, vol):
                np.testing.assert_array_equal(t.numpy(), a)
    assert counts.tolist() == [4, 2]
    # the default counter is the device's own
    before = shift_counts("cpu").clone()
    shift_volume_(vol, torch.tensor((0, 0, 1), dtype=torch.int32))
    shift_volume_(vol, torch.zeros(3, dtype=torch.int32))
    assert (shift_counts("cpu") - before).tolist() == [2, 1]


@pytest.mark.parametrize("dims, vrange, margin", [
    ((128, 128, 128), (3.0, 3.0, 3.0), 0.25),
    ((128, 128, 128), (2.0, 2.0, 2.0), 0.42),
    ((96, 64, 160), (2.4, 1.7, 3.3), 0.3),
])
def test_camera_centering_shift_matches_jax(dims, vrange, margin):
    """int32-exact against JAX on seeded positions inside, below and above
    the central box, on positions half a voxel past a margin (ties), at the
    margins themselves, and on NaN coordinates (a shift of 0)."""
    vs = tuple(r / d for r, d in zip(vrange, dims))
    rng = np.random.default_rng(5)
    pts = [rng.uniform(-0.5 * r, 1.5 * r, (200,)) for r in vrange]
    for c in range(3):
        lo = margin * vrange[c]
        hi = vrange[c] - lo
        k = np.arange(-6, 7) + 0.5
        ties = np.concatenate([lo + k * vs[c], hi + k * vs[c], [lo, hi]])
        pts[c] = np.concatenate([pts[c], ties, [np.nan]])
    n = max(len(p) for p in pts)
    pos = np.stack([np.resize(p, n) for p in pts], axis=-1).astype(np.float32)
    pos[::17, 1] = np.nan
    got = np.stack([camera_centering_shift(torch.as_tensor(p), dims, vs, margin).numpy()
                    for p in pos])
    want = np.stack([np.asarray(jstream.camera_centering_shift(p, dims, vs, margin))
                     for p in pos])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any() and (got[np.isnan(pos)] == 0).all()


# ---- the step -------------------------------------------------------------


def _assert_state_close(got, want, tag):
    """tests/test_torch_mapping.py's one-step tolerances, and the grid's
    offset exactly."""
    np.testing.assert_array_equal(got["origin_vox"], want["origin_vox"], err_msg=tag)
    np.testing.assert_array_equal(got["frame_count"], want["frame_count"], err_msg=tag)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0, atol=POSE_TOL, err_msg=tag)
    touched = want["weight"] > 0
    wdiff = (got["weight"] != want["weight"]).sum()
    assert wdiff <= 1e-4 * touched.sum(), (tag, wdiff, touched.sum())
    gap = np.abs(got["tsdf"].astype(np.int32) - want["tsdf"])
    assert (gap > 0).sum() <= 0.03 * touched.sum(), (tag, (gap > 0).sum(), touched.sum())
    assert (gap > 1).sum() <= 1e-4 * touched.sum(), (tag, (gap > 1).sum(), touched.sum())


@pytest.fixture(scope="module")
def walk():
    """The JAX streaming step over the walk in a child process; the port's
    free-running walk while it works, then the port's step on each JAX
    state."""
    frames = _walk()
    job = torch_jaxref.start([("streaming_track", dict(
        params_kw=tuple(dataclasses.asdict(PARAMS).items()), intr=INTR_T, frames=frames,
        margin_frac=MARGIN))], isa="SSE4_2")
    free = _track(frames)
    (ref,) = job.result()
    forced = _track(frames[:1])
    for k in range(1, N):
        forced += _track(frames[k:k + 1],
                         state=streaming_state_from_numpy(ref[k - 1], device="cpu"))
    return free, forced, ref


def test_streaming_step_matches_jax(walk):
    """The port's step on each JAX state gives JAX's next state: the grid's
    offset exactly (and it moves), the pose within 1e-5, the volume within
    the one-step shares; the free-running walk tracks and shifts as JAX's
    does and keeps the JAX test's bounds on the walked distance."""
    free, forced, ref = walk
    assert all(r["tracking_ok"] for r in ref)
    origins = [r["origin_vox"] for r in ref]
    assert any((o != 0).any() for o in origins)
    for k, ((st, out), r) in enumerate(zip(forced, ref)):
        assert bool(out.tracking_ok), k
        np.testing.assert_allclose(out.pose_matrix.numpy(), r["pose_matrix"], rtol=0,
                                   atol=POSE_TOL, err_msg=f"frame {k}")
        _assert_state_close(st, r, f"frame {k}")
    for k, ((st, out), r) in enumerate(zip(free, ref)):
        assert bool(out.tracking_ok), k
        np.testing.assert_array_equal(st["origin_vox"], r["origin_vox"], err_msg=f"frame {k}")
    final_t = free[-1][1].pose_matrix.numpy()[:3, 3]
    assert abs(final_t[2] - 0.12) < 0.012
    assert abs(final_t[0]) < 0.05 and abs(final_t[1]) < 0.05


def test_fused_streaming_matches_non_fused():
    """tests/test_fused_streaming.py on the port: the fused streaming step
    (the shift, then the warped kernels under the fusion's face flags)
    reproduces the non-fused one (the shift, then the warped dispatchers
    under their own) with the same plain kernels:
    the same grid offsets, not zero, poses within 1e-5, TSDF within 1e-6."""
    scene = default_test_scene()
    traj = make_orbit_trajectory(3, angle_step_deg=0.3)
    frames = [scene.render_frame(T, INTR) for T in traj]
    results = {}
    for mode in ("on", "off"):
        params = KinFuParams(**ALL_WARPED, fused_mode=mode)
        steps = _track(frames, params=params, margin=0.49)
        assert all(bool(out.tracking_ok) for _, out in steps)
        results[mode] = steps
    (st_f, _), (st_s, _) = results["on"][-1], results["off"][-1]
    np.testing.assert_array_equal(st_f["origin_vox"], st_s["origin_vox"])
    assert np.any(st_f["origin_vox"] != 0)
    for (_, of), (_, os_) in zip(results["on"], results["off"]):
        np.testing.assert_allclose(of.pose_matrix.numpy(), os_.pose_matrix.numpy(), atol=1e-5)
    np.testing.assert_allclose(tsdf_to_float(torch.as_tensor(st_f["tsdf"])).numpy(),
                               tsdf_to_float(torch.as_tensor(st_s["tsdf"])).numpy(), atol=1e-6)


@pytest.mark.parametrize("fused_mode", ["on", "off"])
def test_failed_frame_after_a_shift_resets(fused_mode):
    """Frames 0 and 1 (the grid shifts on frame 1), an all-zero depth
    frame, then frame 3: the zero frame fails, the volume is zero, the
    grid's offset 0 and the frame count 1; frame 3 bootstraps."""
    params = PARAMS.replace(fused_mode=fused_mode, raycast_face=(256, 104.0))
    frames = _walk(4)
    d2, c2 = frames[2]
    steps = _track([frames[0], frames[1], (np.zeros_like(d2), c2), frames[3]], params=params)
    assert [bool(out.tracking_ok) for _, out in steps] == [True, True, False, True]
    assert (steps[1][0]["origin_vox"] != 0).any()
    wiped = steps[2][0]
    assert not wiped["tsdf"].any() and not wiped["weight"].any() and not wiped["color"].any()
    assert not wiped["origin_vox"].any() and int(wiped["frame_count"]) == 1
    np.testing.assert_array_equal(wiped["pose"], np.eye(4, dtype=np.float32))
    assert not wiped["model_vmaps"][0].any()
    again = steps[3][0]
    assert int(again["frame_count"]) == 2 and not again["origin_vox"].any()
    assert (again["weight"] > 0).sum() > 1000
